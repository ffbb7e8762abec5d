"""Multi-process jobs of the port's parallel-layer tests (CPU, gloo).

`launch(job, n, work)` starts n ranks of this file as subprocesses (one
OS process per rank, OMP_NUM_THREADS=1, a file:// rendezvous in `work`),
waits for them (300 s each at most) and returns each rank's results, which
the rank saved to <work>/rank<i>.pt. The ranks import the port only
(torch); the tests compare what they saved, with each other, with the
unsharded runs and with the JAX package in the pytest process.

Jobs:
  parallel  (4 ranks) the (data=2, tile=2) mesh (make_mesh and
            make_global_mesh, its errors), tile-collective GroupNorm
            sharded over the tile groups, the tiled VAE's mesh path,
            local_batch_range; then, on rank 0 alone, a world of one
            joined through init_distributed, where a mesh of one must be
            bit-identical to no mesh (tiled VAE, TP decoder logits, ids)
  llama_tp  (4 ranks) TP logits of the cases in <work>/inputs.pt at TP=2
            (the 'data' groups of a 2 x 2 mesh) and TP=4, each rank's
            q_proj rows, generate's ids with and without a mesh; with
            each case's LoRA adapters (this rank's slices), int8's
            row-parallel product with and without them, and a TP=2
            captioner with the archive <work>/lora.npz attached
  paths     (2 ranks) run_stage1_batch at data=2, DP SR3Trainer steps,
            the SR3 CLI's run on a mesh (each rank loading its rows), DP
            VLMTrainer / DPOTrainer / MMTrainer steps on the inputs of
            <work>/vlm.pt; then on rank 0 the CLI's single-process run,
            and a world of one: Stage 1 and the trainers bit-identical to
            no mesh
  engine_tp (2 ranks) DecodeEngine(mesh=) at TP=2 on the tiny decoder
            of <work>/inputs.pt: rank 0 submits and steps, rank 1
            follows; greedy, a speculative round (draft == target),
            prefix + chunked prefill + horizon, sampled from the
            engine's default key, int8 pools; then each case on one process
  sequence  (4 ranks) sequence_parallel_attention over an ("sp",) mesh,
            gpipe_apply over a ("stage",) mesh (a tanh stage, and the
            tiny decoder's blocks one a stage) on the inputs of
            <work>/inputs.pt
"""

from __future__ import annotations

import copy
import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def launch(job: str, n: int, work: Path, timeout: float = 300) -> list:
    """Run `job` on n ranks; their saved results in rank order. Raises with
    the ranks' output when one fails."""
    import torch
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), str(HERE)]))
    for k in ("RSVLDM_COORDINATOR", "RSVLDM_NUM_PROCESSES",
              "RSVLDM_PROCESS_ID", "RSVLDM_DISTRIBUTED", "RSVLDM_BACKEND"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, __file__, job, str(r), str(n),
                               str(work)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"ranks failed {bad}:\n" + "\n".join(
            o[-4000:] for o in outs))
    return [torch.load(work / f"rank{r}.pt", weights_only=False)
            for r in range(n)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init(rank: int, n: int, work: Path):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work}/rendezvous",
                            rank=rank, world_size=n)


def _world_of_one():
    """A fresh process group of this rank alone, joined through the port's
    init_distributed (tcp:// on a free localhost port)."""
    from rsvldm_tpu_torch.parallel.distributed import init_distributed
    assert init_distributed(f"127.0.0.1:{_free_port()}", 1, 0, "gloo")


def _tiny_vae():
    import torch
    from rsvldm_tpu_torch.models.vae.model import AutoencoderKL, VAEConfig
    from rsvldm_tpu_torch.utils.weights import init_params_
    vae = AutoencoderKL(VAEConfig(ch=32, ch_mult=(1, 1, 2, 2),
                                  num_res_blocks=1))
    return init_params_(vae, torch.Generator().manual_seed(0)).eval()


def _vae_both(vae, img, mesh):
    """The tiled encode (48-pixel tiles) and decode (6-latent tiles), 4
    tiles each, of img [1, 3, 96, 96]."""
    import torch
    from rsvldm_tpu_torch.models.vae import tiled
    with torch.no_grad():
        z = tiled.tiled_encode(vae.encode_with_denoise, img, tile=48,
                               mesh=mesh)
        y = tiled.tiled_decode(vae.decode, z, tile=6, mesh=mesh)
    return z, y


def _tiny_llama(mode: str | None):
    import torch
    from rsvldm_tpu_torch.models.vlm.llama import (LlamaConfig, LlamaModel,
                                                   quantize_llama_)
    from rsvldm_tpu_torch.utils.weights import init_params_
    cfg = LlamaConfig(vocab_size=128, dim=32, layers=2, heads=8, kv_heads=4,
                      ffn_dim=64)
    m = init_params_(LlamaModel(cfg), torch.Generator().manual_seed(1)).eval()
    if mode:
        quantize_llama_(m, mode, group=8)
    return m


def _logits(model, toks, lora=None):
    import torch
    from rsvldm_tpu_torch.models.vlm.llama import KVCache
    with torch.no_grad():
        cache = KVCache.init(model.cache_cfg, 1, 16, device="cpu")
        return model(model.embed(toks), cache, 0, lora=lora)[0]


def _rank_lora(model, lora):
    """This rank's slices of `lora` on a sharded decoder, else `lora`."""
    from rsvldm_tpu_torch.parallel.llama_sharding import (int4_group_of,
                                                          shard_lora,
                                                          shard_plan)
    if model.tp is None:
        return lora
    plan = shard_plan(model.cfg, model.tp.size, int4_group_of(model))
    return shard_lora(lora, plan, model.tp.rank)


def _lora_logits(model, toks, lora, scale):
    """Logits with adapters passed to the forward (this rank's slices on a
    sharded decoder): folded into a dense decoder's weights there, the
    runtime branch of a quantized one."""
    from rsvldm_tpu_torch.training.vlm_trainer import runtime_lora
    return _logits(model, toks, runtime_lora(_rank_lora(model, lora), scale))


def _int8_row_parallel(m, mt, lora, scale) -> dict:
    """Layer 0's int8 o_proj, whole on one process against its TP shard
    through row_parallel, on one seeded input: without adapters (bit for
    bit, the exact int32 sum), and with them (the r-wide partial summed
    apart)."""
    import torch
    from rsvldm_tpu_torch.models.vlm.llama import row_parallel
    from rsvldm_tpu_torch.training.vlm_trainer import runtime_lora
    path = "model.layers.0.self_attn.o_proj"
    whole, part = (x.model.layers[0].self_attn.o_proj for x in (m, mt))
    tp = mt.model.layers[0].tp_attn
    x = torch.randn((1, 8, whole.kernel_q.shape[0]),
                    generator=torch.Generator().manual_seed(4))
    per = x.shape[-1] // tp.size
    xs = x[..., tp.rank * per:(tp.rank + 1) * per]
    lw = runtime_lora(lora, scale)[path]
    lt = runtime_lora(_rank_lora(mt, lora), scale)[path]
    with torch.no_grad():
        base, base_tp = whole(x), row_parallel(part, xs, tp)
        with_l, with_l_tp = whole(x, lw), row_parallel(part, xs, tp, lt)
    return dict(base_equal=torch.equal(base, base_tp),
                lora_err=float((with_l - with_l_tp).abs().max()),
                branch=float((with_l - base).abs().max()),
                scale=float(with_l.abs().max()))


def job_parallel(rank: int, n: int, work: Path) -> dict:
    import torch
    import torch.distributed as dist
    from rsvldm_tpu_torch.ops.norm import GroupNorm32, tile_collective_gn
    from rsvldm_tpu_torch.parallel.distributed import (init_distributed,
                                                       local_batch_range,
                                                       make_global_mesh)
    from rsvldm_tpu_torch.parallel.llama_sharding import shard_llama_
    from rsvldm_tpu_torch.parallel.mesh import (batch_sharding, make_mesh,
                                                shard_tiled_gn_apply)
    from rsvldm_tpu_torch.models.vlm.generate import GenerateConfig, generate
    _init(rank, n, work)
    inp = torch.load(work / "inputs.pt")
    res: dict = {"init_again": init_distributed()}
    res["local_batch_range"] = local_batch_range(8)
    mesh = make_mesh(tile=2)
    rows = batch_sharding(mesh, 8)
    res.update(mesh_shape=list(mesh.shape), batch_rows=[rows.start, rows.stop],
               tile_group=dist.get_process_group_ranks(mesh.get_group("tile")),
               data_group=dist.get_process_group_ranks(mesh.get_group("data")))
    gm = make_global_mesh(tile=2)
    res["global_mesh"] = [list(gm.shape), dist.get_process_group_ranks(
        gm.get_group("tile"))]
    res["global_mesh_errors"] = []
    for tile, per_host in ((3, None), (8, "8")):  # checked before any group
        if per_host:
            os.environ["LOCAL_WORLD_SIZE"] = per_host
        try:
            make_global_mesh(tile=tile)
        except ValueError as e:
            res["global_mesh_errors"].append(str(e))
        os.environ.pop("LOCAL_WORLD_SIZE", None)
    gn = GroupNorm32(inp["gn_x"].shape[1], eps=1e-6)
    with torch.no_grad():
        gn.weight.copy_(inp["gn_w"])
        gn.bias.copy_(inp["gn_b"])
        res["gn_sharded"] = shard_tiled_gn_apply(gn, mesh, "tile")(inp["gn_x"])
        with tile_collective_gn():
            res["gn_single"] = gn(inp["gn_x"])
    vae = _tiny_vae()
    res["vae_mesh"] = _vae_both(vae, inp["img"], mesh)
    res["vae_none"] = _vae_both(vae, inp["img"], None)
    dist.destroy_process_group()
    if rank == 0:
        _world_of_one()
        one = make_mesh(1)
        res["one_vae_equal"] = all(torch.equal(a, b) for a, b in zip(
            _vae_both(vae, inp["img"], one), res["vae_none"]))
        toks = torch.tensor([[3, 17, 99, 42, 7, 1, 0, 5]])
        res["one_logits_equal"], res["one_ids_equal"] = {}, {}
        res["one_tp_none"] = {}
        for mode in (None, "int8", "int4"):
            m = _tiny_llama(mode)
            mt = shard_llama_(copy.deepcopy(m), one.get_group("data"))
            res["one_tp_none"][str(mode)] = mt.tp is None
            res["one_logits_equal"][str(mode)] = torch.equal(_logits(m, toks),
                                                             _logits(mt, toks))
            gcfg = GenerateConfig(max_new_tokens=6, do_sample=False, pad_to=8)
            e = m.embed(toks[0])
            res["one_ids_equal"][str(mode)] = bool(
                (generate(m, e, gcfg) == generate(mt, e, gcfg)).all())
        res["one_captioner"] = _captioner_of_one(one)
        dist.destroy_process_group()
    return res


def _tiny_captioner_kw() -> dict:
    from rsvldm_tpu_torch.models.vlm.llama import LlamaConfig
    from rsvldm_tpu_torch.models.vlm.vision import CLIPVisionConfig
    # 128-wide heads and FFN: whole int4 groups on each of 2 row shards
    return dict(llama_cfg=LlamaConfig(vocab_size=64, dim=256, layers=2,
                                      heads=2, kv_heads=2, ffn_dim=256),
                vision_cfg=CLIPVisionConfig(image_size=28, patch_size=14,
                                            width=24, layers=1, heads=2),
                tokenizer=object(), device="cpu")


def _same_tensors(a: dict, b: dict) -> bool:
    import torch
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _captioner_of_one(one) -> dict:
    """LlavaCaptioner.seeded over a mesh of one against no mesh, per
    quant: the decoders' tensors equal, and the decoder left without
    `tp` (its decode steps then stay captured on a card)."""
    from rsvldm_tpu_torch.models.vlm.captioner import LlavaCaptioner
    kw = _tiny_captioner_kw()
    out = {}
    for quant in (None, "int8", "int4"):
        got = LlavaCaptioner.seeded(**kw, quant=quant, mesh=one).llama
        want = LlavaCaptioner.seeded(**kw, quant=quant).llama
        out[str(quant)] = dict(
            equal=_same_tensors(got.state_dict(), want.state_dict()),
            tp_none=got.tp is None)
    return out


def _q_rows(model) -> int:
    q = model.model.layers[0].self_attn.q_proj
    if hasattr(q, "kernel_q4"):
        return q.kernel_q4.shape[1]
    if hasattr(q, "kernel_q"):
        return q.kernel_q.shape[1]
    return q.weight.shape[0]


def job_llama_tp(rank: int, n: int, work: Path) -> dict:
    import torch
    from rsvldm_tpu_torch.models.vlm.generate import GenerateConfig, generate
    from rsvldm_tpu_torch.models.vlm.llama import (LlamaConfig, LlamaModel,
                                                   quantize_llama_)
    from rsvldm_tpu_torch.parallel.llama_sharding import shard_llama_
    from rsvldm_tpu_torch.parallel.mesh import make_mesh
    _init(rank, n, work)
    inp = torch.load(work / "inputs.pt")
    meshes = {2: make_mesh(tile=2), 4: make_mesh(tile=1)}
    toks = inp["toks"]
    noise = inp["noise"]
    greedy = GenerateConfig(max_new_tokens=6, do_sample=False, pad_to=8)
    sampled = GenerateConfig(max_new_tokens=6, temperature=0.7, pad_to=8)
    res: dict = {}
    for name, case in inp["cases"].items():
        cfg = LlamaConfig(**case["cfg"])
        m = LlamaModel(cfg)
        m.load_state_dict(case["sd"], strict=True)
        m.eval().requires_grad_(False)
        if case["mode"]:
            quantize_llama_(m, case["mode"], group=case["group"])
        e = m.embed(toks[0])
        ref_ids = generate(m, e, greedy)
        ref_sampled = generate(m, e, sampled, noise=lambda i: noise[i])
        out = {"unsharded": _logits(m, toks), "q_rows_full": _q_rows(m)}
        lora = case.get("lora")
        if lora is not None:
            out["unsharded_lora"] = _lora_logits(m, toks, lora, case["scale"])
        for tp, mesh in meshes.items():
            mt = shard_llama_(copy.deepcopy(m), mesh.get_group("data"))
            out[tp] = dict(
                logits=_logits(mt, toks), q_rows=_q_rows(mt),
                greedy_equal=bool((generate(mt, e, greedy) == ref_ids).all()),
                sampled_equal=bool((generate(mt, e, sampled,
                                             noise=lambda i: noise[i])
                                    == ref_sampled).all()))
            if lora is not None:
                out[tp]["lora_logits"] = _lora_logits(mt, toks, lora,
                                                      case["scale"])
            if lora is not None and case["mode"] == "int8":
                out[tp]["int8_row_parallel"] = _int8_row_parallel(
                    m, mt, lora, case["scale"])
        res[name] = out
    res["lean_build_equal"] = _lean_build_equal(meshes[2])
    res["captioner_lora"] = _captioner_lora(meshes[2], work / "lora.npz")
    return res


def _captioner_lora(mesh, npz: Path) -> dict:
    """LlavaCaptioner.seeded over the mesh's TP groups with the archive
    `npz` attached (no longer refused) against the whole captioner with
    it, per quant: the decoders' logits (the runtime branch or the fold),
    and whether the rank holds slices of the adapters."""
    import torch
    from rsvldm_tpu_torch.models.vlm.captioner import LlavaCaptioner
    kw = _tiny_captioner_kw()
    toks = torch.tensor([[3, 17, 60, 42, 7, 1, 0, 5]])
    out = {}
    for quant in (None, "int8", "int4"):
        caps = [LlavaCaptioner.seeded(**kw, quant=quant, mesh=m)
                for m in (None, mesh)]
        for cap in caps:
            cap.attach_archives(lora_npz=npz)
        whole, part = (_logits(c.llama, toks, c.lora) for c in caps)
        base = _logits(LlavaCaptioner.seeded(**kw, quant=quant).llama, toks)
        q = "model.layers.0.self_attn.q_proj"
        out[str(quant)] = dict(
            whole=whole, tp=part, base=base, tp_set=caps[1].llama.tp is not None,
            b_cols=None if caps[1].lora is None else caps[1].lora[q]["b"].shape[1])
    return out


def _lean_build_equal(mesh) -> dict:
    """LlavaCaptioner.seeded and from_state_dict with a mesh (each rank
    building its shard part by part) against the whole captioner built the
    same way, then shard_llama_: the decoders' tensors equal, per quant."""
    from rsvldm_tpu_torch.models.vlm.captioner import LlavaCaptioner
    from rsvldm_tpu_torch.models.vlm.llama import quantize_llama_
    from rsvldm_tpu_torch.parallel.llama_sharding import shard_llama_
    kw = _tiny_captioner_kw()
    same = _same_tensors
    out = {}
    for quant in (None, "int8", "int4"):
        whole = LlavaCaptioner.seeded(**kw)
        sd = {**{k: v.clone() for k, v in whole.llama.state_dict().items()},
              **{"model.vision_tower.vision_tower." + k: v
                 for k, v in whole.vision.state_dict().items()},
              **{"model.mm_projector." + k: v
                 for k, v in whole.projector.state_dict().items()},
              "model.image_newline": whole.image_newline}
        if quant:
            quantize_llama_(whole.llama, quant)
        want = shard_llama_(whole.llama, mesh.get_group("data")).state_dict()
        seeded = LlavaCaptioner.seeded(**kw, quant=quant, mesh=mesh)
        loaded = LlavaCaptioner.from_state_dict(sd, **kw, quant=quant,
                                                mesh=mesh)
        out[str(quant)] = dict(
            seeded=same(seeded.llama.state_dict(), want),
            from_state_dict=same(loaded.llama.state_dict(), want))
    return out


def _tiny_pipe(work: Path, mesh=None):
    from rsvldm_tpu_torch.config import PipelineConfig
    from rsvldm_tpu_torch.infer import tiny_model_cfgs
    from rsvldm_tpu_torch.pipeline import SuperResolutionPipeline
    cfg = PipelineConfig(no_llava=True, ckpt_dir=str(work / "no_ckpt"),
                         upscale=4)
    cfg.stage1.sampler, cfg.stage1.ddim_steps = "ddim", 4
    return SuperResolutionPipeline(cfg, device="cpu",
                                   model_cfgs=tiny_model_cfgs(), mesh=mesh)


def _dp_train(work: Path, mesh, steps: int = 3) -> tuple:
    """`steps` SR3Trainer steps on the tiny UNet at global batch 4: this
    rank's rows with a mesh, all of them without; (losses, parameters,
    the parameters they started from)."""
    import numpy as np
    import torch
    from rsvldm_tpu_torch.models.sr3.unet import SR3UNetConfig
    from rsvldm_tpu_torch.parallel.mesh import batch_sharding
    from rsvldm_tpu_torch.train_sr3 import TINY_SR3
    from rsvldm_tpu_torch.training.sr3_trainer import SR3TrainConfig, SR3Trainer
    mc = dataclasses.replace(SR3UNetConfig(image_size=16), **TINY_SR3)
    tr = SR3Trainer(mc, SR3TrainConfig(lr=1e-3), device="cpu", mesh=mesh,
                    seed=0)
    rng = np.random.default_rng(5)
    hr, sr = (torch.from_numpy(rng.uniform(-1, 1, (4, 16, 16, 3))
                               .astype(np.float32)) for _ in range(2))
    if mesh is not None:
        rows = batch_sharding(mesh, 4)
        hr, sr = hr[rows], sr[rows]
    flat = lambda: torch.cat([p.detach().reshape(-1).clone()
                              for p in tr.model.parameters()])
    start = flat()
    from rsvldm_tpu_torch.utils import prng
    keys = prng.split(prng.key(1), steps)
    losses = [tr.train_step(hr, sr, key=k) for k in keys]
    return losses, flat(), start


def _vlm_dp(work: Path, mesh, rank: int, steps: int = 3) -> dict:
    """`steps` steps each of VLMTrainer and MMTrainer (LoRA and the
    projector) on the int8 base and DPOTrainer on the fp32 base of
    <work>/vlm.pt, on its inputs at their global batch: this rank's rows
    with a mesh, all of them without. A
    rank other than the mesh's first starts from adapters and a projector
    moved by +1, which the broadcast must replace. {trainer: (losses,
    adapters after them, the projector's state dict or None)}; over a mesh
    of 2, also `dpo_uneven`: DPOTrainer on the first 3 pairs on the first
    rank and the last on the second."""
    import torch
    from rsvldm_tpu_torch.models.vlm.llama import (LlamaConfig, LlamaModel,
                                                   quantize_llama_)
    from rsvldm_tpu_torch.models.vlm.projector import MLPProjector
    from rsvldm_tpu_torch.parallel.mesh import batch_sharding, mesh_size
    from rsvldm_tpu_torch.training import vlm_trainer as tt
    inp = torch.load(work / "vlm.pt")
    cfg = LlamaConfig(**inp["cfg"])
    bump = 1.0 if mesh is not None and rank else 0.0

    def model(quant: bool = True):
        m = LlamaModel(cfg)
        m.load_state_dict(inp["sd"])
        m.requires_grad_(False)
        return (quantize_llama_(m, "int8", embed_dtype=torch.float32)
                if quant else m)

    def lora(name):
        return {p: {n: t.clone() + bump for n, t in ab.items()}
                for p, ab in inp["lora"][name].items()}

    def cut(*xs):
        if mesh is None:
            return xs
        rows = batch_sharding(mesh, xs[0].shape[0])
        return tuple(x[rows] for x in xs)

    def state(tr):
        return {p: {n: t.detach().clone() for n, t in ab.items()}
                for p, ab in tr.lora.items()}

    lcfg = tt.LoraConfig(**inp["lora_cfg"])
    lr = inp["lr"]
    out = {}
    tr = tt.VLMTrainer(model(), lcfg, lr=lr, lora=lora("vlm"), mesh=mesh)
    batch = cut(*inp["vlm"])
    out["vlm"] = ([tr.train_step(*batch) for _ in range(steps)], state(tr),
                  None)
    tr = tt.DPOTrainer(model(False), lcfg, lr=lr, lora=lora("dpo"),
                       mesh=mesh)
    batch = cut(*inp["dpo"])
    out["dpo"] = ([tr.train_step(*batch) for _ in range(steps)], state(tr),
                  None)
    proj = MLPProjector(*inp["proj_dims"])
    proj.load_state_dict(inp["proj"])
    with torch.no_grad():
        for p in proj.parameters():
            p.add_(bump)
    if mesh is not None and mesh_size(mesh) == 2:
        # the same pairs split 3 / 1 over the ranks
        tr = tt.DPOTrainer(model(False), lcfg, lr=lr, lora=lora("dpo"),
                           mesh=mesh)
        rows = slice(0, 3) if rank == 0 else slice(3, 4)
        batch = tuple(x[rows] for x in inp["dpo"])
        out["dpo_uneven"] = ([tr.train_step(*batch) for _ in range(steps)],
                             state(tr), None)
    tr = tt.MMTrainer(model(), proj, lcfg, tune=("lora", "projector"), lr=lr,
                      mm_projector_lr=inp["proj_lr"], lora=lora("mm"),
                      mesh=mesh)
    vis, emb, pos, labels = inp["mm"]
    vis, emb, labels = cut(vis, emb, labels)
    (pos,) = cut(pos)
    out["mm"] = ([tr.train_step(vis, emb, pos.tolist(), labels)
                  for _ in range(steps)], state(tr),
                 {k: v.clone() for k, v in proj.state_dict().items()})
    return out


def _cli_train(work: Path, save: str, mesh) -> list:
    """The SR3 CLI's run (train_sr3.build_trainer + run) for 3 steps of
    global batch 4 over <work>/data (10 samples: an epoch of 2 batches);
    its losses."""
    from rsvldm_tpu_torch import train_sr3
    args = train_sr3.parse_args([
        "--data_root", str(work / "data"), "--l_res", "4", "--r_res", "16",
        "--batch_size", "4", "--steps", "3", "--save_dir", str(work / save),
        "--debug_tiny", "--device", "cpu", "--num_workers", "0",
        "--prefetch", "1", "--log_every", "1"])
    losses: list = []
    train_sr3.run(args, train_sr3.build_trainer(args, mesh=mesh),
                  on_step=lambda r: losses.append(r["loss"]))
    return losses


def _folder_failure(work: Path, mesh, rank: int):
    """ImageBatchProcessor (stage1_only) whose batched Stage 1 raises on
    every rank: under a mesh of 2 the error is raised (True), with no mesh
    the per-image fallback runs and its statuses are returned."""
    from rsvldm_tpu_torch.config import PipelineConfig
    from rsvldm_tpu_torch.infer import tiny_model_cfgs
    from rsvldm_tpu_torch.pipeline import ImageBatchProcessor
    cfg = PipelineConfig(no_llava=True, ckpt_dir=str(work / "no_ckpt"),
                         upscale=4, stage1_only=True,
                         image_dir=str(work / "lr"),
                         output_dir=str(work / f"folder_{rank}_{mesh is None}"))
    cfg.stage1.sampler, cfg.stage1.ddim_steps = "ddim", 4
    proc = ImageBatchProcessor(cfg, device="cpu", mesh=mesh,
                               model_cfgs=tiny_model_cfgs())

    def fail(*a, **k):
        raise RuntimeError("planted batched Stage 1 failure")
    proc.pipe.run_stage1_batch = fail
    try:
        statuses = proc.run()
    except RuntimeError as e:
        return "planted" in str(e)
    return dict(statuses=statuses, fallbacks=[s for s, _ in proc.fallbacks])


def job_paths(rank: int, n: int, work: Path) -> dict:
    import torch.distributed as dist
    from rsvldm_tpu_torch.parallel.mesh import make_mesh
    _init(rank, n, work)
    paths = sorted((work / "lr").glob("*.png"))
    mesh = make_mesh(tile=1)
    res: dict = {"stage1_mesh": _tiny_pipe(work, mesh).run_stage1_batch(
        paths, mesh=mesh)}
    res["stage1_none"] = _tiny_pipe(work).run_stage1_batch(paths)
    res["train_mesh"] = _dp_train(work, mesh)
    res["train_none"] = _dp_train(work, None)
    res["cli_dp_losses"] = _cli_train(work, "ck_dp", mesh)
    res["vlm_mesh"] = _vlm_dp(work, mesh, rank)
    res["vlm_none"] = _vlm_dp(work, None, rank)
    res["folder_raises_sharded"] = _folder_failure(work, mesh, rank)
    dist.destroy_process_group()
    if rank == 0:
        res["folder_fallback_alone"] = _folder_failure(work, None, rank)
        res["cli_single_losses"] = _cli_train(work, "ck_single", None)
        _world_of_one()
        one = make_mesh(1)
        res["one_stage1"] = _tiny_pipe(work, one).run_stage1_batch(paths,
                                                                   mesh=one)
        res["one_train"] = _dp_train(work, one)
        res["one_vlm"] = _vlm_dp(work, one, 0)
        dist.destroy_process_group()
    return res


def _engine_model(inp: dict, kv_quant: bool = False):
    from rsvldm_tpu_torch.models.vlm.llama import LlamaConfig, LlamaModel
    m = LlamaModel(LlamaConfig(**inp["geom"], kv_quant=kv_quant))
    m.load_state_dict(inp["sd"])
    return m.eval().requires_grad_(False)


def _engine_case(name: str, inp: dict, mesh, rank: int) -> dict:
    """One engine case; with a mesh rank 0 drives and the others follow.
    Returns {uid: ids} (rank 0's streams on every rank), the nonces, and
    what the case checks beside."""
    import torch
    from rsvldm_tpu_torch.serving.engine import DecodeEngine
    cfgs = inp["cfgs"]
    model = _engine_model(inp, kv_quant=False)
    kw = dict(slots=2, max_len=64, pad_to=8)
    ps = [torch.from_numpy(x) for x in inp["prompts"]]
    if name == "spec":
        kw.update(draft=model, spec_k=2)
    elif name == "options":
        kw.update(prefill_chunk=8, decode_horizon=3)
    elif name == "int8":
        kw.update(kv_8bit=True)
    eng = DecodeEngine(model, mesh=mesh, **kw)
    out: dict = {"sharded": eng.model.tp is not None,
                 "q_rows": eng.model.model.layers[0].self_attn.q_proj.weight.shape[0],
                 "cache": {k: tuple(getattr(eng.cache, k).shape)
                           for k in ("k", "v", "k_scale", "v_scale")
                           if getattr(eng.cache, k) is not None}}
    if rank == 0:
        cfg = cfgs["sampled" if name == "sampled" else "greedy"]
        if name == "options":
            pid = eng.register_prefix(torch.from_numpy(inp["prefix"]))
            for suf in inp["suffixes"]:
                eng.submit(torch.from_numpy(suf), cfg, prefix_id=pid)
            eng.submit(torch.from_numpy(inp["long"]), cfg)
            eng.run_until_idle()
            out["steps"] = dict(eng.steps)
            eng.drop_prefix(pid)
        else:
            eng.generate_all(ps, cfg)
        if mesh is not None:
            eng.stop_followers()
    else:
        eng.follow()
    out["ids"] = {uid: eng.result(uid) for uid in sorted(eng._requests)}
    out["nonces"] = {uid: r.nonce for uid, r in eng._requests.items()}
    out["disagreements"] = eng.disagreements
    out["admissions"] = eng.admissions
    out["prefixes_left"] = len(eng._prefixes)
    return out


ENGINE_CASES = ("greedy", "spec", "options", "sampled", "int8")


def job_engine_tp(rank: int, n: int, work: Path) -> dict:
    import torch
    import torch.distributed as dist
    from rsvldm_tpu_torch.models.vlm.llama import KVCache, LlamaConfig
    from rsvldm_tpu_torch.parallel.llama_sharding import shard_kv_cache
    from rsvldm_tpu_torch.parallel.mesh import make_mesh
    _init(rank, n, work)
    inp = torch.load(work / "inputs.pt", weights_only=False)
    mesh = make_mesh(tile=1)
    res = {"tp": {c: _engine_case(c, inp, mesh, rank) for c in ENGINE_CASES}}
    # the int8 pool cut as shard_kv_cache cuts a whole one
    full = KVCache.init(LlamaConfig(**inp["geom"], kv_quant=True), 2, 64)
    res["int8_cut"] = {k: tuple(getattr(shard_kv_cache(full, n, rank), k).shape)
                       for k in ("k", "v", "k_scale", "v_scale")}
    if rank:
        from rsvldm_tpu_torch.serving.engine import DecodeEngine
        eng = DecodeEngine(_engine_model(inp), slots=1, max_len=64, pad_to=8,
                           mesh=mesh)
        try:
            eng.submit(torch.from_numpy(inp["prompts"][0]),
                       inp["cfgs"]["greedy"])
        except RuntimeError as e:
            res["follower_submit"] = str(e)
    dist.destroy_process_group()
    res["one"] = {c: _engine_case(c, inp, None, 0) for c in ENGINE_CASES}
    return res


def job_sequence(rank: int, n: int, work: Path) -> dict:
    import torch
    import torch.distributed as dist
    from torch.func import functional_call
    from rsvldm_tpu_torch.models.vlm.llama import LlamaConfig, LlamaModel
    from rsvldm_tpu_torch.parallel import (gpipe_apply, make_mesh,
                                           sequence_parallel_attention,
                                           stack_stage_params)
    _init(rank, n, work)
    inp = torch.load(work / "inputs.pt", weights_only=False)
    res: dict = {"sp": {}}
    sp = make_mesh(axis="sp")
    res["sp_mesh"] = (tuple(sp.mesh_dim_names), tuple(sp.shape))
    for key, (q, k, v) in inp["sp"].items():
        per = q.shape[1] // n
        cut = lambda x: x[:, rank * per:(rank + 1) * per].contiguous()
        res["sp"][key] = sequence_parallel_attention(
            cut(q), cut(k), cut(v), sp, "sp", causal=key[0])
    stage = make_mesh(axis="stage")
    g = inp["gpipe"]
    stacked = stack_stage_params(g["stages"])
    res["gpipe"] = gpipe_apply(lambda p, x: torch.tanh(x @ p["w"] + p["b"]),
                               stacked, g["x"], stage, "stage")
    # the decoder's blocks, one a stage; this rank passes its slice alone
    lm = inp["llama"]
    model = LlamaModel(LlamaConfig(**lm["geom"]))
    model.load_state_dict(lm["sd"])
    model.eval().requires_grad_(False)
    blocks = list(model.model.layers)
    stacked = stack_stage_params([dict(b.state_dict()) for b in blocks])
    mine = {key: val[rank:rank + 1] for key, val in stacked.items()}
    fn = lambda p, x: functional_call(blocks[0], p, (x, None, None, 0))
    with torch.no_grad():
        emb = model.embed(lm["toks"])
        h = gpipe_apply(fn, mine, emb[None], stage, "stage")[0]
        res["llama_logits"] = model.lm_head(model.model.norm(h))
    dist.destroy_process_group()
    return res


JOBS = {"parallel": job_parallel, "llama_tp": job_llama_tp, "paths": job_paths,
        "engine_tp": job_engine_tp, "sequence": job_sequence}


if __name__ == "__main__":
    import torch
    job, rank, n, work = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
        Path(sys.argv[4])
    out = JOBS[job](rank, n, work)
    torch.save(out, work / f"rank{rank}.pt")
