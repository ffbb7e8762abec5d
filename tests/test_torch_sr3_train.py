"""The port's SR3 training held against the JAX package at the tiny SR3
geometry, fp32 on the CPU: sr3_loss drawing JAX's split(rng, 3) draws from
the same key (t and u bit-equal, the normals within 1e-6), the EMA,
the lr schedules, the SDXL diffusion loss, the LRHR datasets, augmentation
and the loader (equal arrays), save / load / resume against an
uninterrupted run, and the train_sr3 CLI against the root JAX CLI's printed
losses and saved parameters after three steps, both drawing from the seed
alone. Tolerances as
tests/test_torch_training.py: loss atol 1e-5, parameters after three steps
atol 1e-4."""

import dataclasses
import io
import random
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import rsvldm_tpu.models.sr3 as jsr3_pkg
import rsvldm_tpu.parallel
from rsvldm_tpu.data import datasets as jds
from rsvldm_tpu.data import prefetch as jprefetch
from rsvldm_tpu.models.sr3 import SR3Diffusion as JSR3Diffusion
from rsvldm_tpu.models.sr3 import SR3UNet as JSR3UNet
from rsvldm_tpu.models.sr3 import sr3_loss as jsr3_loss
from rsvldm_tpu.training import ema as jema
from rsvldm_tpu.training import losses as jlosses
from rsvldm_tpu.training import lr_schedule as jlr
from rsvldm_tpu.utils.checkpoint import load_orbax
from rsvldm_tpu_torch import train_sr3
from rsvldm_tpu_torch.data import datasets as tds
from rsvldm_tpu_torch.data import prefetch as tprefetch
from rsvldm_tpu_torch.models.sr3.diffusion import (SR3Diffusion, sr3_draws,
                                                   sr3_loss)
from rsvldm_tpu_torch.models.sr3.unet import SR3UNet
from rsvldm_tpu_torch.training import ema as tema
from rsvldm_tpu_torch.training import losses as tlosses
from rsvldm_tpu_torch.training import lr_schedule as tlr
from rsvldm_tpu_torch.training.sr3_trainer import SR3TrainConfig, SR3Trainer
from rsvldm_tpu_torch.utils import prng
from rsvldm_tpu_torch.utils.weights import params_from_jax
from torch_parity_lib import JAX_TINY, TORCH_TINY, randomize, to_np

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
R, L, N = 16, 4, 2  # HR side, LR side, batch


def _close(got, want, atol, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol)


def jax_draws(key, b, shape, T):
    """(t, u, noise) as JAX's sr3_loss draws them from `key`."""
    k_t, k_g, k_n = jax.random.split(key, 3)
    t = jax.random.randint(k_t, (b,), 1, T + 1)
    u = jax.random.uniform(k_g, (b,))
    noise = jax.random.normal(k_n, shape, jnp.float32)
    return (torch.from_numpy(np.asarray(t)).long(),
            torch.from_numpy(np.asarray(u)),
            torch.from_numpy(np.asarray(noise)))


def _pkey(key) -> tuple:
    return tuple(int(v) for v in np.asarray(key))


@pytest.fixture(scope="module")
def sr3_tree():
    jm = JSR3UNet(JAX_TINY["sr3"])
    return to_np(randomize(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((1, R, R, 6)),
        jnp.ones((1, 1))), 51))


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_sr3_loss_equal_jax(sr3_tree, loss_type):
    """The loss and a gradient from JAX's key (T = 2000, the train
    schedule), nothing injected: loss atol 1e-5, gradient atol 2e-5 + rtol
    1e-4; the draws themselves: t and u bit-equal, the normals within
    1e-6 relative."""
    rng = np.random.default_rng(1)
    hr = rng.uniform(-1, 1, (N, R, R, 3)).astype(np.float32)
    sr = rng.uniform(-1, 1, (N, R, R, 3)).astype(np.float32)
    jdiff = JSR3Diffusion.from_schedule("linear", 2000, 1e-6, 1e-2)
    jm = JSR3UNet(JAX_TINY["sr3"])
    key = jax.random.PRNGKey(9)
    want, gwant = jax.jit(jax.value_and_grad(lambda p: jsr3_loss(
        jdiff, jm.apply, p, jnp.asarray(hr), jnp.asarray(sr), key,
        loss_type)))(sr3_tree)
    model = SR3UNet(TORCH_TINY["sr3"])
    model.load_state_dict(params_from_jax("sr3", sr3_tree, TORCH_TINY["sr3"]))
    diff = SR3Diffusion.from_schedule("linear", 2000, 1e-6, 1e-2)
    loss = sr3_loss(diff, model, torch.from_numpy(hr), torch.from_numpy(sr),
                    key=_pkey(key), loss_type=loss_type)
    _close(float(loss), float(want), atol=1e-5)
    loss.backward()
    gw = params_from_jax("sr3", to_np(gwant), TORCH_TINY["sr3"])
    for name in ("final_conv.block.3.weight", "noise_level_mlp.1.weight",
                 "downs.0.weight"):
        _close(dict(model.named_parameters())[name].grad, gw[name],
               atol=2e-5, rtol=1e-4)
    t, u, noise = sr3_draws(diff, hr.shape, _pkey(key), "cpu")
    jt, ju, jn = jax_draws(key, N, hr.shape, 2000)
    assert torch.equal(t, jt) and torch.equal(u, ju)
    _close(noise, jn, atol=1e-6, rtol=1e-6)


def test_ema_update_equal_jax():
    """Twelve updates at decay 0.5, fp32: the warmup (1 + s) / (10 + s) is
    the smaller decay for steps 1-8, the decay itself from step 9; equal
    to JAX's within 1e-7."""
    rng = np.random.default_rng(2)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    js = jema.ema_init({k: jnp.asarray(v) for k, v in p0.items()})
    ts = tema.ema_init({k: torch.from_numpy(v) for k, v in p0.items()})
    for _ in range(12):
        new = {k: rng.standard_normal(v.shape).astype(np.float32)
               for k, v in p0.items()}
        js = jema.ema_update(js, {k: jnp.asarray(v) for k, v in new.items()},
                             0.5)
        tema.ema_update(ts, {k: torch.from_numpy(v) for k, v in new.items()},
                        0.5)
        for k in p0:
            _close(ts.params[k], js.params[k], atol=1e-7)
    assert ts.step == int(js.step) == 12


def test_lr_schedules_equal_jax():
    steps = np.arange(0, 130, 3)
    got = tlr.lambda_warmup_cosine(10, 0.1, 1.0, 0.01, 100)(steps)
    want = jlr.lambda_warmup_cosine(10, 0.1, 1.0, 0.01, 100)(steps)
    _close(got, want, atol=1e-6)
    args = ([5, 8], [0.1, 0.05], [1.0, 0.5], [0.0, 0.1], [40, 60])
    _close(tlr.lambda_warmup_cosine2(*args)(steps),
           jlr.lambda_warmup_cosine2(*args)(steps), atol=1e-6)
    assert float(tlr.lambda_warmup_cosine(10, 0.1, 1.0, 0.01, 100)(0)) == \
        pytest.approx(0.01)


@pytest.mark.parametrize("sampler,weighting,loss_type", [
    ("discrete", "eps", "l2"), ("edm", "unit", "l1"), ("edm", "eps", "l2")])
def test_standard_diffusion_loss_equal_jax(sampler, weighting, loss_type):
    """The loss from JAX's key, nothing injected, within 1e-5, and its
    draws (split, then the sigma's normal or randint index and the noise)
    within 1e-6 relative; then the same with the draws given."""
    x0 = np.random.default_rng(3).standard_normal((3, 4, 4, 2)).astype(
        np.float32)
    cfg_kw = dict(sigma_sampler=sampler, weighting=weighting,
                  loss_type=loss_type)
    key = jax.random.PRNGKey(4)
    den = lambda x, s: 0.8 * x + 0.05 * s.reshape(-1, 1, 1, 1)
    want = jlosses.standard_diffusion_loss(
        den, jnp.asarray(x0), key, jlosses.StandardDiffusionLossConfig(**cfg_kw))
    got = tlosses.standard_diffusion_loss(
        den, torch.from_numpy(x0), tlosses.StandardDiffusionLossConfig(**cfg_kw),
        key=_pkey(key))
    _close(float(got), float(want), atol=1e-5, rtol=1e-5)
    k_s, k_n = jax.random.split(key)
    pk_s, pk_n = prng.split(_pkey(key))
    sigma = (tlosses.edm_sigma_sampling(3, key=pk_s) if sampler == "edm"
             else tlosses.discrete_sigma_sampling(3, key=pk_s))
    _close(sigma, jlosses.edm_sigma_sampling(k_s, 3) if sampler == "edm"
           else jlosses.discrete_sigma_sampling(k_s, 3), atol=0, rtol=1e-6)
    noise = prng.normal(pk_n, x0.shape)
    _close(noise, jax.random.normal(k_n, x0.shape), atol=1e-6, rtol=1e-6)
    got = tlosses.standard_diffusion_loss(
        den, torch.from_numpy(x0), tlosses.StandardDiffusionLossConfig(**cfg_kw),
        sigma=sigma, noise=noise)
    _close(float(got), float(want), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- data
def _write_lrhr(root: Path, n: int = 5, seed: int = 0) -> Path:
    rng = np.random.default_rng(seed)
    for sub in (f"hr_{R}", f"sr_{L}_{R}", f"lr_{L}"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        hr = Image.fromarray((rng.random((R, R, 3)) * 255).astype(np.uint8))
        lr = hr.resize((L, L), Image.BICUBIC)
        hr.save(root / f"hr_{R}" / f"{i:03d}.png")
        lr.save(root / f"lr_{L}" / f"{i:03d}.png")
        lr.resize((R, R), Image.BICUBIC).save(root / f"sr_{L}_{R}" / f"{i:03d}.png")
    return root


def test_lrhr_dataset_augment_and_loader_equal_jax(tmp_path):
    root = _write_lrhr(tmp_path)
    t = tds.LRHRDataset(str(root), L, R, need_lr=True)
    j = jds.LRHRDataset(str(root), L, R, need_lr=True)
    assert len(t) == len(j) == 5
    for i in range(5):
        for a, b in zip(t.getitem_rng(i, random.Random(i)),
                        j.getitem_rng(i, random.Random(i))):
            np.testing.assert_array_equal(a, b)
    arrs = [np.arange(24, dtype=np.float32).reshape(2, 4, 3)] * 2
    for seed in range(6):
        for a, b in zip(tds.augment(arrs, rot=True, rng=random.Random(seed)),
                        jds.augment(arrs, rot=True, rng=random.Random(seed))):
            np.testing.assert_array_equal(a, b)
    val = tds.LRHRDataset(str(root), L, R, split="val", data_len=3)
    assert len(val) == 3 and not val.hflip
    for workers in (0, 2):
        got = tprefetch.make_loader(t, 2, num_workers=workers, seed=3,
                                    epochs=2, device="cpu")
        want = jprefetch.make_loader(j, 2, num_workers=workers, seed=3,
                                     epochs=2)
        got, want = list(got), list(want)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert all(isinstance(x, torch.Tensor) for x in g)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


class _Env:
    """An lmdb.Environment-like mapping of bytes keys."""

    def __init__(self, store):
        self.store = store

    def begin(self):
        env = self

        class Txn:
            def __enter__(self):
                return self

            def __exit__(self, *a):
                return False

            def get(self, k):
                return env.store.get(k)
        return Txn()


def test_lmdb_dataset_equal_jax(tmp_path):
    rng = np.random.default_rng(4)
    store = {b"length": b"3"}
    for i in range(3):
        for key in (f"hr_{R}_{i:05d}", f"sr_{L}_{R}_{i:05d}", f"lr_{L}_{i:05d}"):
            buf = io.BytesIO()
            Image.fromarray((rng.random((R, R, 3)) * 255).astype(np.uint8)).save(
                buf, format="PNG")
            store[key.encode()] = buf.getvalue()
    t = tds.LmdbLRHRDataset(_Env(store), L, R, need_lr=True)
    j = jds.LmdbLRHRDataset(_Env(store), L, R, need_lr=True)
    assert len(t) == len(j) == 3
    for i in range(3):
        for a, b in zip(t.getitem_rng(i, random.Random(7)),
                        j.getitem_rng(i, random.Random(7))):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError):
        tds.LmdbLRHRDataset(_Env({b"length": b"9"}), L, R)[5]


def test_loader_defaults_to_cuda():
    """Without device= the loader stages onto CUDA, as the entry points
    do: on a machine without a card it raises instead of handing back host
    tensors."""
    if torch.cuda.is_available():
        it = tprefetch.make_loader([(np.zeros(2),)] * 4, 2, num_workers=0)
        assert next(it)[0].device.type == "cuda"
        it.close()
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprefetch.prefetch_to_device(iter([(np.zeros(2),)]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprefetch.make_loader([(np.zeros(2),)] * 4, 2, num_workers=0)


def test_prefetch_raises_the_workers_error():
    def gen():
        yield (np.zeros(2),)
        raise KeyError("bad record")
    it = tprefetch.prefetch_to_device(gen(), size=1, device="cpu")
    assert next(it)[0].shape == (2,)
    with pytest.raises(KeyError, match="bad record"):
        next(it)


# ------------------------------------------------------------- trainer
def _tiny_trainer(seed=0):
    cfg = TORCH_TINY["sr3"]
    return SR3Trainer(cfg, SR3TrainConfig(lr=1e-3), device="cpu", seed=seed)


def test_resume_equals_uninterrupted(tmp_path):
    """Three steps, save; a new trainer loads the files; its fourth step
    (the same batch and draws) equals the uninterrupted trainer's: loss,
    parameters, Adam moments and EMA bit for bit."""
    rng = np.random.default_rng(5)
    batches = [(rng.uniform(-1, 1, (N, R, R, 3)).astype(np.float32),
                rng.uniform(-1, 1, (N, R, R, 3)).astype(np.float32))
               for _ in range(4)]
    a = _tiny_trainer()
    keys = prng.split(prng.key(1), 4)
    for (hr, sr), k in zip(batches[:3], keys):
        a.train_step(hr, sr, key=k)
    a.save(tmp_path)
    assert {p.name for p in tmp_path.iterdir()} == {"I3_gen.pth",
                                                    "I3_opt.pth"}
    b = _tiny_trainer(seed=9).load(tmp_path, 3)
    assert b.step == 3 and b.ema.step == 3
    la = a.train_step(*batches[3], key=keys[3])
    lb = b.train_step(*batches[3], key=keys[3])
    assert la == lb
    for (k, va), vb in zip(a.model.state_dict().items(),
                           b.model.state_dict().values()):
        assert torch.equal(va, vb), k
    for k in a.ema.params:
        assert torch.equal(a.ema.params[k], b.ema.params[k])
    sa, sb = a.opt.state_dict()["state"], b.opt.state_dict()["state"]
    assert all(torch.equal(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"]) for i in sa)
    # the saved UNet loads into the inference model as the reference file
    m = SR3UNet(TORCH_TINY["sr3"])
    m.load_state_dict(torch.load(tmp_path / "I3_gen.pth", weights_only=True))


def test_cli_three_steps_equal_jax(tmp_path, monkeypatch, capsys):
    """The root train_sr3.py (tiny SR3 config patched in, its loader, its
    PRNGKey(seed + 1) draws) and `python -m rsvldm_tpu_torch.train_sr3
    --debug_tiny` from JAX's initial weights, its draws from the seed alone
    (PRNGKey(seed + 1) split a step): the same
    printed losses (within 1e-5 plus the 5-decimal rounding) and, from the
    files each wrote, the same UNet and EMA after three steps (atol 1e-4);
    then --resume_iter 3 takes a fourth step and writes I4. The batch is
    the CLI's default 8."""
    b = 8
    root = _write_lrhr(tmp_path / "data", n=11)
    jcfg = JAX_TINY["sr3"]
    monkeypatch.setattr(jsr3_pkg, "SR3UNetConfig",
                        lambda image_size: dataclasses.replace(
                            jcfg, image_size=image_size))
    monkeypatch.setenv("RSVLDM_COMPILE_CACHE", "0")
    # one device, as a user's CPU run has: the test session's 8 virtual CPU
    # devices would make the CLI shard, and orbax then saves every replica
    monkeypatch.setattr(rsvldm_tpu.parallel, "make_mesh", lambda **kw: None)
    base = ["--data_root", str(root), "--l_res", str(L), "--r_res", str(R),
            "--batch_size", str(b), "--log_every", "1", "--num_workers", "0",
            "--seed", "2"]
    common = [*base, "--steps", "3"]
    sys.path.insert(0, str(REPO))
    import train_sr3 as jcli
    monkeypatch.setattr(sys, "argv", ["train_sr3.py", *common, "--save_dir",
                                      str(tmp_path / "jax")])
    jcli.main()
    printed = capsys.readouterr().out
    want = [float(x) for x in re.findall(r"step \d+: loss ([0-9.]+)", printed)]
    assert len(want) == 3
    # the JAX trainer's init, PRNGKey(seed)
    j_init = JSR3UNet(jcfg).init(jax.random.PRNGKey(2), jnp.zeros((1, R, R, 6)),
                                 jnp.ones((1, 1)))
    args = train_sr3.parse_args([*common, "--debug_tiny", "--device", "cpu",
                                 "--save_dir", str(tmp_path / "port")])
    assert train_sr3.model_config(args) == TORCH_TINY["sr3"]
    trainer = train_sr3.build_trainer(
        args, state_dict=params_from_jax("sr3", to_np(j_init),
                                         TORCH_TINY["sr3"]))
    got = []
    train_sr3.run(args, trainer, on_step=lambda r: got.append(r["loss"]))
    printed = capsys.readouterr().out
    assert re.findall(r"step (\d+): loss", printed) == ["1", "2", "3"]
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-5 + 5e-6
    jparams = params_from_jax("sr3", to_np(load_orbax(tmp_path / "jax" / "I3_gen")),
                              TORCH_TINY["sr3"])
    jstate = load_orbax(tmp_path / "jax" / "I3_state")
    jema_sd = params_from_jax("sr3", to_np(jstate["ema_params"]),
                              TORCH_TINY["sr3"])
    saved = torch.load(tmp_path / "port" / "I3_gen.pth", weights_only=True)
    opt = torch.load(tmp_path / "port" / "I3_opt.pth", weights_only=True)
    assert opt["iter"] == 3 and opt["ema_step"] == 3 == int(jstate["ema_step"])
    for k, v in jparams.items():
        _close(saved[k], v, atol=1e-4)
        _close(opt["ema"][k], jema_sd[k], atol=1e-4)
    train_sr3.main([*base, "--steps", "4", "--debug_tiny", "--device", "cpu",
                    "--save_dir", str(tmp_path / "port"), "--resume_iter", "3"])
    assert "step 4: loss" in capsys.readouterr().out
    assert torch.load(tmp_path / "port" / "I4_opt.pth",
                      weights_only=True)["iter"] == 4
