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
            q_proj rows, generate's ids with and without a mesh
  paths     (2 ranks) run_stage1_batch at data=2, DP SR3Trainer steps,
            the SR3 CLI's run on a mesh (each rank loading its rows); then
            on rank 0 the CLI's single-process run, and a world of one:
            Stage 1 and the trainer bit-identical to no mesh
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


def _logits(model, toks):
    import torch
    from rsvldm_tpu_torch.models.vlm.llama import KVCache
    with torch.no_grad():
        cache = KVCache.init(model.cache_cfg, 1, 16, device="cpu")
        return model(model.embed(toks), cache, 0)[0]


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
        for tp, mesh in meshes.items():
            mt = shard_llama_(copy.deepcopy(m), mesh.get_group("data"))
            out[tp] = dict(
                logits=_logits(mt, toks), q_rows=_q_rows(mt),
                greedy_equal=bool((generate(mt, e, greedy) == ref_ids).all()),
                sampled_equal=bool((generate(mt, e, sampled,
                                             noise=lambda i: noise[i])
                                    == ref_sampled).all()))
        res[name] = out
    res["lean_build_equal"] = _lean_build_equal(meshes[2])
    return res


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
                    generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    hr, sr = (torch.from_numpy(rng.uniform(-1, 1, (4, 16, 16, 3))
                               .astype(np.float32)) for _ in range(2))
    if mesh is not None:
        rows = batch_sharding(mesh, 4)
        hr, sr = hr[rows], sr[rows]
    flat = lambda: torch.cat([p.detach().reshape(-1).clone()
                              for p in tr.model.parameters()])
    start = flat()
    gen = torch.Generator().manual_seed(1)
    losses = [tr.train_step(hr, sr, generator=gen) for _ in range(steps)]
    return losses, flat(), start


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
        dist.destroy_process_group()
    return res


JOBS = {"parallel": job_parallel, "llama_tp": job_llama_tp, "paths": job_paths}


if __name__ == "__main__":
    import torch
    job, rank, n, work = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
        Path(sys.argv[4])
    out = JOBS[job](rank, n, work)
    torch.save(out, work / f"rank{rank}.pt")
