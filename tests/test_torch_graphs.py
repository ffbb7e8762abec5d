"""Capture safety of the port's loop steps, on the CPU.

On the card every loop of process() (the caption decode, SR3 and DDIM,
RestoreEDM's first / rest / update) is one step function captured into a
CUDA graph and replayed; a host read inside a step would break the capture
or bake the first step's value into the graph. Here each step body runs,
at tiny width, under a dispatch mode that refuses the two ways a tensor
reaches the host or a shape follows the data: `aten._local_scalar_dense`
(`.item()`, `int()`, `bool()`, `float()`) and `aten.nonzero`. The reads
between steps (the decode's done flag every few steps, RestoreEDM's hit
flag once a step) stay outside. Then the runner's bookkeeping of the
kernels' launch counters, with a stub graph and a stub counter."""

import contextlib
import gc

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rsvldm_tpu_torch.diffusion import samplers
from rsvldm_tpu_torch.models.sdxl.control import ControlledUNet, GLVControl
from rsvldm_tpu_torch.models.sdxl.denoiser import ControlDenoiser
from rsvldm_tpu_torch.models.sdxl.unet import SDXLUNetConfig
from rsvldm_tpu_torch.models.sr3 import diffusion as sr3_diffusion
from rsvldm_tpu_torch.models.sr3.unet import SR3UNet, SR3UNetConfig
from rsvldm_tpu_torch.models.vlm import generate as tgen
from rsvldm_tpu_torch.models.vlm.llama import (LlamaConfig, LlamaModel,
                                               quantize_llama_)
from rsvldm_tpu_torch.training.vlm_trainer import (LoraConfig, init_lora,
                                                   runtime_lora)
from rsvldm_tpu_torch.utils import graphs

torch.set_num_threads(1)
HOST_READS = (torch.ops.aten._local_scalar_dense.default,
              torch.ops.aten.nonzero.default)


class NoHostReads(TorchDispatchMode):
    """Raises on any op that reads a tensor's value on the host or gives
    a shape that depends on the data."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in HOST_READS:
            raise AssertionError(f"host read inside a loop step: {func}")
        return func(*args, **(kwargs or {}))


class GuardedRunner:
    """StepRunner's direct path with every call under NoHostReads;
    records the step functions it ran."""
    ran: list = []
    capture_s = 0.0

    def __init__(self, fn, graphs):
        self.fn = fn

    def __call__(self, *args):
        GuardedRunner.ran.append(getattr(self.fn, "__name__", "?"))
        with NoHostReads():
            return self.fn(*args)


@pytest.fixture
def guarded(monkeypatch):
    for mod in (tgen, sr3_diffusion, samplers):
        monkeypatch.setattr(mod, "StepRunner", GuardedRunner)
    GuardedRunner.ran = []
    return GuardedRunner.ran


@pytest.mark.parametrize("read", [lambda t: t.item(), int, bool, float,
                                  lambda t: t.nonzero()])
def test_guard_catches_host_reads(read):
    t = torch.ones(())
    with pytest.raises(AssertionError, match="host read"), NoHostReads():
        read(t if read is not bool else t > 0)


# ---------------------------------------------------------------- decode
_L = dict(vocab_size=256, dim=32, layers=2, heads=4, kv_heads=2, ffn_dim=64)


def _llama(mode):
    torch.manual_seed(0)
    m = LlamaModel(LlamaConfig(**_L)).eval().requires_grad_(False)
    for p in m.parameters():
        p.data.normal_(0.0, 0.2)
    return quantize_llama_(m, mode) if mode else m


@pytest.mark.parametrize("mode,lora", [(None, False), ("int8", False),
                                       ("int4", False), ("int4", True),
                                       ("int8", True)])
def test_decode_step_has_no_host_read(guarded, mode, lora):
    """The decode step, sampled at T = 0.2 and greedy: dense, int8, int4
    and with a runtime LoRA on the quantized decoder."""
    m = _llama(mode)
    ad = None
    if lora:
        ad = init_lora(m, LoraConfig(r=4))
        for ab in ad.values():
            ab["b"].normal_(0.0, 0.1)
        ad = runtime_lora(ad, LoraConfig(r=4).scale)
    embeds = torch.randn(5, 32, generator=torch.Generator().manual_seed(1))
    for sample in (True, False):
        cfg = tgen.GenerateConfig(max_new_tokens=20, do_sample=sample,
                                  eot_ids=(1000,), pad_to=8)
        ids = tgen.generate(m, embeds, cfg, lora=ad)
        assert len(ids) == 20
    assert guarded == ["<lambda>"] * 38


def test_decode_step_advances_on_the_device():
    """One call of decode_step moves the position and index by one and
    writes the token it feeds next; after the first eot, eot is forced."""
    m = _llama(None)
    cfg = tgen.GenerateConfig(max_new_tokens=4, do_sample=False, pad_to=8)
    st = tgen._decode_state(m, cfg, 8, torch.device("cpu"))
    st.pos.fill_(5)
    st.eot.fill_(7)
    with torch.inference_mode(), NoHostReads():
        tgen.decode_step(m, st, None)
        st.done.fill_(True)
        tgen.decode_step(m, st, None)
    assert int(st.pos) == 7 and int(st.idx) == 2
    assert int(st.toks[2]) == 7 and int(st.tok) == 7


# ------------------------------------------------------------------- SR3
SR3_TINY = SR3UNetConfig(inner_channel=16, norm_groups=8, channel_mults=(1, 2),
                         attn_res=(8,), res_blocks=1, image_size=16)


def test_sr3_steps_have_no_host_read(guarded):
    torch.manual_seed(0)
    model = SR3UNet(SR3_TINY).eval()
    diff = sr3_diffusion.SR3Diffusion.from_schedule("linear", 6, 1e-6, 1e-2)
    cond = torch.rand(1, 16, 16, 3) * 2 - 1
    x = sr3_diffusion.sr3_sample(diff, model, cond, torch.randn(7, 1, 16, 16, 3))
    ts = sr3_diffusion.ddim_timesteps(6, 4)
    y = sr3_diffusion.sr3_sample_ddim(diff, model, cond,
                                      torch.randn(len(ts) + 1, 1, 16, 16, 3),
                                      num_steps=4, eta=0.5)
    assert torch.isfinite(x).all() and torch.isfinite(y).all()
    assert guarded == ["step"] * (6 + len(ts))


# ------------------------------------------------------------- RestoreEDM
SDXL_TINY = SDXLUNetConfig(model_channels=32, num_res_blocks=1,
                           attention_resolutions=(2,), channel_mult=(1, 2),
                           num_head_channels=16, transformer_depth=(1, 1),
                           context_dim=64, adm_in_channels=32 + 3 * 512)


@pytest.mark.parametrize("threshold", [0.0, 1e9])
def test_restore_edm_steps_have_no_host_read(guarded, threshold):
    """first + the relative-L1 change, rest + CFG + the update (misses),
    the update alone (hits: a threshold no change reaches), with churn,
    the restore-CFG drift and a linear control scale all on."""
    torch.manual_seed(0)
    den = ControlDenoiser(unet=ControlledUNet(SDXL_TINY).eval(),
                          control_net=GLVControl(SDXL_TINY).eval())
    g = torch.Generator().manual_seed(2)
    mk = lambda *s: torch.randn(*s, generator=g)
    conds = [dict(crossattn=mk(1, 7, 64), vector=mk(1, SDXL_TINY.adm_in_channels),
                  control=mk(1, 8, 8, 4)) for _ in range(2)]
    cfg = samplers.RestoreEDMConfig(num_steps=4, img_threshold=threshold,
                                    restore_cfg=4.0, use_linear_control_scale=True,
                                    control_scale_start=0.5)
    z, aux = samplers.restore_edm_sample(den, *conds, mk(1, 8, 8, 4),
                                         mk(1, 8, 8, 4), cfg,
                                         churn_noise=mk(4, 1, 8, 8, 4),
                                         return_aux=True)
    assert torch.isfinite(z).all()
    if threshold > 0:
        assert aux["hit_trace"].tolist() == [False, True, True, True]
        assert guarded == ["first", "rest"] + ["first", "update"] * 3
    else:
        assert guarded == ["first", "rest"] * 4


# ------------------------------------------------------- the runner itself
class _StubGraph:
    captures = 0

    def replay(self):
        pass


@contextlib.contextmanager
def _stub_capture(graph):
    _StubGraph.captures += 1
    yield


class _Counter:
    launches = 0


@pytest.fixture
def stub_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph", _stub_capture)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    _StubGraph.captures = 0


def test_runner_counts_launches_through_replays(stub_cuda):
    """The first call runs the step (3 launches counted by the wrapper),
    the second captures it (3 recorded, none run: taken back) and replays
    it, later calls replay: every call counts 3, the body ran twice."""
    counter, other = _Counter(), _Counter()
    ran = []

    def step():
        ran.append(1)
        counter.launches += 3
        return "out"

    runner = graphs.StepRunner(step, True, counters=(counter, other))
    outs = [runner() for _ in range(5)]
    assert counter.launches == 15 and other.launches == 0
    assert len(ran) == 2 and _StubGraph.captures == 1
    assert runner.replays == 4 and runner.capture_s > 0
    assert outs == ["out"] * 5


def test_runner_refuses_other_args_and_does_not_fall_back(stub_cuda):
    a, b = torch.zeros(1), torch.zeros(1)
    runner = graphs.StepRunner(lambda t: t, True, counters=())
    runner(a)
    runner(a)
    with pytest.raises(ValueError, match="tensors of its capture"):
        runner(b)

    def fails_at_capture():
        if _StubGraph.captures:
            raise RuntimeError("capture failed")

    _StubGraph.captures = 0
    runner = graphs.StepRunner(fails_at_capture, True, counters=())
    runner()
    with pytest.raises(RuntimeError, match="capture failed"):
        runner()
    assert runner.graph is None


def test_capture_runs_without_the_garbage_collector(stub_cuda):
    """The collector is held off during a capture (a CUDA graph destroyed
    inside another's capture invalidates it), then restored, also after a
    failed capture."""
    seen = []

    def step():
        seen.append(gc.isenabled())
        if len(seen) == 4:
            raise RuntimeError("capture failed")

    runner = graphs.StepRunner(step, True, counters=())
    runner()
    runner()
    assert seen == [True, False] and gc.isenabled()
    runner = graphs.StepRunner(step, True, counters=())
    runner()
    with pytest.raises(RuntimeError, match="capture failed"):
        runner()
    assert seen[3] is False and gc.isenabled()


def test_direct_runner_and_device_choice():
    counter = _Counter()
    runner = graphs.StepRunner(lambda: setattr(counter, "launches",
                                               counter.launches + 1),
                               False, counters=(counter,))
    for _ in range(4):
        runner()
    assert counter.launches == 4 and runner.replays == 0
    cpu = torch.device("cpu")
    assert graphs.use_graphs(cpu, None) is False
    assert graphs.use_graphs(cpu, False) is False
    with pytest.raises(ValueError, match="need a CUDA device"):
        graphs.use_graphs(cpu, True)
    assert [c.__name__ for c in graphs.kernel_counters()] == [
        "flash_attention", "flash_attention_bwd", "int4_matmul", "draw",
        "draw_folded"]
