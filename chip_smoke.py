#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (rsvldm_tpu_torch).

    python3 chip_smoke.py            # every phase, one NVIDIA GPU (sm_90a)

Phases, each printed on its own line:
  1. device   the card's name and power limit (nvidia-smi), torch and CUDA
  2. build    K1 (rsvldm_tpu_torch/csrc/flash_fwd.cu) with nvcc for sm_90a
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the main path's shapes and a few edge cases; kernel, plain and
              library times, and the least time the card could take
  4. reference process() at a small width on the card (bf16, K1 in use)
              against the same run in fp32 on the CPU: same weights, same
              noise, PNGs within a stated uint8 tolerance
  5. path     SuperResolutionPipeline.process() with no_llava at full width
              (SR3 64-ch, SDXL XL-base + GLVControl, SDXL VAE, CLIP-L, bigG),
              seeded random bf16 weights, a seeded 28x28 input: 224^2 Stage 1,
              1024^2 (128^2 latent) Stage 2b. Kernel launch counts are reset
              just before and read just after.
  6. profile  (--profile) one cache-miss and one cache-hit denoising step
              under torch.profiler: device time by kernel, idle share
The line before the last is the kernel report as one JSON object; the last
line is {"ok": true, "device": {...}}, printed only when every phase passed.
Exits non-zero, with no result, when there is no CUDA card or the port's
package is not beside this script.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_HBM_BYTES = 3.35e12  # HBM3 bandwidth, H100 SXM data sheet

REPO = Path(__file__).resolve().parent
SEED = 0  # weights, input image and noise are all made from it
# bf16 on the card against fp32 on the CPU, through 8 SR3 and 4 EDM steps
# of random-weight networks: an H100 gave 0.62 mean / 3 max uint8 levels on
# the final PNG (0.08 / 1 after Stage 1); the limits leave 2.4x / 4x margin
REF_MEAN_TOL, REF_MAX_TOL = 1.5, 12
# K1 against its plain version, both in bf16 on the card. Per element
# |err| <= ATOL + RTOL*|ref|, and over the whole output
# rms(err) <= RMS_TOL*rms(ref). At sdxl_s4096 the outputs are small (rms about
# 0.026), so ATOL is a few bf16 ulps of the largest of them; a kernel that
# skipped one of the 64 K/V tiles there would be off by about 0.1*rms(ref).
K1_ATOL, K1_RTOL, K1_RMS_TOL = 4e-3, 2e-2, 1e-2
K1_LSE_TOL = 1e-4  # lse is fp32 on both sides
# K1 sites per denoising step of the full-width XL-base UNet + GLVControl:
# 34 in GLVControl, 24 in the UNet input blocks, 48 in `rest`. A cache hit
# runs GLVControl and the input blocks only.
K1_PER_MISS, K1_PER_HIT = 106, 58


def _say(phase: str, **kw):
    print(f"[{phase}] " + json.dumps(kw, sort_keys=True), flush=True)


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------- phase 1
def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not line:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(line, flush=True)
    _say("device", nvidia_smi=line, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         kind=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)))
    return line


# --------------------------------------------------------------- phase 2
def phase_build():
    from rsvldm_tpu_torch.ops.flash_attention import SOURCE
    from rsvldm_tpu_torch.utils import cuda_build
    t0 = time.perf_counter()
    log = cuda_build.build(SOURCE)
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    _say("build", source=SOURCE, ptxas=ptxas,
         seconds=round(time.perf_counter() - t0, 3))


# --------------------------------------------------------------- phase 3
def _valid_pairs(sq, sk, kv_len, causal):
    if not causal:
        return sq * kv_len
    off = kv_len - sq
    return sum(min(max(r + off + 1, 0), kv_len) for r in range(sq))


def _flash_case(name, b, sq, sk, h, d, *, causal=False, kv_len=None,
                lse=False, timed=False, main_path=False):
    import torch
    import torch.nn.functional as F
    from rsvldm_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_ref)
    gen = torch.Generator(device="cuda").manual_seed(
        sum(map(ord, name)) + sq * 7 + sk)
    mk = lambda s: torch.randn((b, s, h, d), generator=gen, device="cuda",
                               dtype=torch.bfloat16)
    q, k, v = mk(sq), mk(sk), mk(sk)
    kvl = sk if kv_len is None else kv_len
    kw = dict(causal=causal, kv_len=kvl, return_lse=lse)
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = flash_attention_ref(q, k, v, **kw)
    o, r = (out[0].float(), ref[0].float()) if lse else (out.float(),
                                                          ref.float())
    err = (o - r).abs()
    tol = K1_ATOL + K1_RTOL * r.abs()
    rms = lambda x: float(x.square().mean().sqrt())
    rel_rms = rms(err) / max(rms(r), 1e-30)
    ok = (bool((err <= tol).all()) and rel_rms <= K1_RMS_TOL
          and bool(torch.isfinite(o).all()))
    rec = dict(case=name, shape=[b, sq, sk, h, d], causal=causal,
               kv_len=kvl, max_abs_err=float(err.max()),
               max_err_over_tol=float((err / tol).max()),
               rms_ref=rms(r), mean_abs_ref=float(r.abs().mean()),
               rel_rms_err=rel_rms,
               tol=f"|err| <= {K1_ATOL} + {K1_RTOL}*|ref|, "
                   f"rms(err) <= {K1_RMS_TOL}*rms(ref)")
    if lse:
        lse_err = float((out[1] - ref[1]).abs().max())
        rec["lse_max_abs_err"] = lse_err
        ok = ok and lse_err <= K1_LSE_TOL
    if causal and sq > kvl:
        rec["zero_rows_exact"] = bool((o[:, :sq - kvl] == 0).all())
        ok = ok and rec["zero_rows_exact"]
    pairs = _valid_pairs(sq, sk, kvl, causal)
    flops = 4.0 * b * h * d * pairs
    nbytes = 2 * (2 * b * sq * h * d + 2 * b * sk * h * d)
    if lse:
        nbytes += 4 * b * h * sq
    rec["bound_ms"] = max(flops / H100_BF16_FLOPS,
                          nbytes / H100_HBM_BYTES) * 1e3
    rec["bound_by"] = ("operations" if flops / H100_BF16_FLOPS
                       >= nbytes / H100_HBM_BYTES else "bytes")
    if timed:
        n_launch = flash_attention.launches
        rec["ms"] = _time_ms(lambda: flash_attention(q, k, v, **kw), 20)
        flash_attention.launches = n_launch  # comparison launches not counted
        rec["plain_ms"] = _time_ms(lambda: flash_attention_ref(q, k, v, **kw),
                                   3, warmup=1)
        rec["tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
        # the yardstick: one PyTorch call computing the same function, where
        # one exists (SDPA gives NaN, not zeros, for rows with no valid key)
        if not (causal and sq > kvl):
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            mask = None
            if kvl != sk or (causal and sq != sk):
                key = torch.arange(sk, device="cuda")
                mask = (key < kvl)[None, :].expand(sq, sk)
                if causal:
                    row = torch.arange(sq, device="cuda")[:, None]
                    mask = mask & (key[None, :] <= row + (kvl - sq))
            sdpa = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None)
            rec["library_ms"] = _time_ms(sdpa, 20)
        else:
            rec["library_ms"] = None
    rec["ok"] = ok
    rec["main_path"] = main_path
    _say("kernels", **rec)
    return rec


def phase_kernels():
    from rsvldm_tpu_torch.ops.flash_attention import flash_attention
    flash_attention.launches = 0
    cases = [
        # the slice's shapes: SDXL self-attention at 64^2 and 32^2 latents
        _flash_case("sdxl_s4096", 2, 4096, 4096, 10, 64, timed=True,
                    main_path=True),
        _flash_case("sdxl_s1024", 2, 1024, 1024, 20, 64, timed=True,
                    main_path=True),
        # Llama prefill shape of the caption slice
        _flash_case("causal_d128", 1, 2048, 2048, 32, 128, causal=True,
                    timed=True),
        _flash_case("causal_sq_lt_sk", 1, 300, 700, 4, 64, causal=True),
        _flash_case("causal_sq_gt_sk", 1, 700, 300, 4, 64, causal=True,
                    lse=True),
        _flash_case("ragged_kv_len_lse", 2, 1000, 1024, 8, 128,
                    kv_len=777, lse=True),
        _flash_case("ragged_causal_lse", 1, 513, 1100, 2, 64, causal=True,
                    kv_len=1000, lse=True),
    ]
    flash_attention.launches = 0
    return cases


# --------------------------------------------------------------- phase 4
def phase_reference(seed: int):
    """process() at a small width on the card (bf16, K1 at 1024 tokens)
    against the same run on the CPU in fp32, with the same weights and the
    same noise. Cache off, so no threshold decision can flip between the two
    precisions. Passes when the PNGs agree to REF_MEAN_TOL mean and
    REF_MAX_TOL max uint8 levels."""
    import numpy as np
    import torch
    from PIL import Image
    from rsvldm_tpu_torch.config import (PipelineConfig, RefinementConfig,
                                         Stage1Config)
    from rsvldm_tpu_torch.models.sdxl.unet import SDXLUNetConfig
    from rsvldm_tpu_torch.models.sr3.unet import SR3UNetConfig
    from rsvldm_tpu_torch.models.text.clip import CLIPTextConfig
    from rsvldm_tpu_torch.models.vae.model import VAEConfig
    from rsvldm_tpu_torch.ops.flash_attention import flash_attention
    from rsvldm_tpu_torch.pipeline import (ReplayNoise, SuperResolutionPipeline,
                                           TorchNoise)

    # 64-channel heads so the self-attention at the 32^2 level (1024 tokens
    # of a 64^2 latent) and the ZeroCrossAttn there run on K1
    small = dict(
        sr3=SR3UNetConfig(inner_channel=32, norm_groups=8, channel_mults=(1, 2),
                          attn_res=(8,), res_blocks=1, image_size=16),
        sdxl=SDXLUNetConfig(model_channels=64, num_res_blocks=1,
                            attention_resolutions=(2,), channel_mult=(1, 2),
                            num_head_channels=64, transformer_depth=(1, 1),
                            context_dim=64, adm_in_channels=32 + 3 * 512),
        vae=VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1),
        clip_l=CLIPTextConfig(vocab_size=1000, width=32, layers=2, heads=2),
        big_g=CLIPTextConfig(vocab_size=1000, width=32, layers=2, heads=2,
                             quick_gelu=False, use_text_projection=True,
                             openclip=True))
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_ref_"))
    rng = np.random.default_rng(seed + 1)
    Image.fromarray((rng.random((4, 4, 3)) * 255).astype(np.uint8)).save(
        work / "lr.png")

    def cfg(out):
        return PipelineConfig(input_img=str(work / "lr.png"),
                              output_dir=str(work / out), upscale=4,
                              seed=seed, no_llava=True,
                              params_dtype="fp32" if out == "cpu" else "bf16",
                              stage1=Stage1Config(steps=8),
                              refine=RefinementConfig(min_size=128, edm_steps=4,
                                                      img_threshold=0.0))

    draws: dict = {}
    cpu_noise = TorchNoise(seed, torch.device("cpu"))

    def recording(name, shape):
        draws.setdefault(name, []).append(cpu_noise(name, shape).clone())
        return draws[name][-1]

    cpu = SuperResolutionPipeline(cfg("cpu"), device="cpu", model_cfgs=small,
                                  noise=recording)
    cpu.process()
    sds = {fam: getattr(cpu, fam).state_dict() for fam in
           ("sr3", "unet", "control", "vae", "clip_l", "big_g")}
    gpu = SuperResolutionPipeline(cfg("gpu"), device="cuda", model_cfgs=small,
                                  state_dicts=sds, noise=ReplayNoise(draws))
    flash_attention.launches = 0
    gpu.process()
    launches = flash_attention.launches
    rec = dict(k1_launches=launches)
    ok = launches > 0
    for name in ("sr3_lr.png", "lr_final_0.png"):
        a = np.asarray(Image.open(work / "cpu" / name), np.int16)
        b = np.asarray(Image.open(work / "gpu" / name), np.int16)
        d = np.abs(a - b)
        rec[name] = dict(shape=list(a.shape), mean_abs=float(d.mean()),
                         max_abs=int(d.max()))
        ok = ok and a.shape == b.shape and d.mean() <= REF_MEAN_TOL \
            and d.max() <= REF_MAX_TOL
    rec["tol"] = f"mean <= {REF_MEAN_TOL}, max <= {REF_MAX_TOL} uint8 levels"
    rec["ok"] = bool(ok)
    _say("reference", **rec)
    return rec


# --------------------------------------------------------------- phase 5
def phase_path(seed: int):
    import numpy as np
    import torch
    from PIL import Image
    from rsvldm_tpu_torch.config import PipelineConfig
    from rsvldm_tpu_torch.ops.flash_attention import flash_attention
    from rsvldm_tpu_torch.pipeline import SuperResolutionPipeline

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    rng = np.random.default_rng(seed)
    lr = (rng.random((28, 28, 3)) * 255).astype(np.uint8)
    Image.fromarray(lr).save(work / "lr.png")
    cfg = PipelineConfig(input_img=str(work / "lr.png"),
                         output_dir=str(work / "out"), upscale=8, seed=seed,
                         no_llava=True)
    t0 = time.perf_counter()
    pipe = SuperResolutionPipeline(cfg, device="cuda")
    pipe.ensure_stage2()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for m in (pipe.sr3, pipe.unet, pipe.control,
                                       pipe.vae, pipe.clip_l, pipe.big_g)
                   for p in m.parameters())
    torch.cuda.reset_peak_memory_stats()

    flash_attention.launches = 0
    t0 = time.perf_counter()
    pipe.process()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = flash_attention.launches

    sr = np.asarray(Image.open(work / "out" / "sr3_lr.png"))
    fin = np.asarray(Image.open(work / "out" / "lr_final_0.png"))
    dfb = pipe.last_dfb
    rec = dict(init_s=round(init_s, 3), process_s=round(total_s, 3),
               stage_s={k: round(v, 3) for k, v in pipe.timings.items()},
               params=n_params, stage1_steps=cfg.stage1.steps,
               edm_steps=cfg.refine.edm_steps, dfb_hits=dfb["hits"],
               dfb_steps=dfb["steps"],
               dfb_trace="".join("H" if x else "." for x in dfb["trace"]),
               flash_fwd_launches=launches,
               peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3),
               sr3_png=list(sr.shape), final_png=list(fin.shape),
               outputs_finite=pipe.outputs_finite,
               sr3_std=float(sr.std()), final_std=float(fin.std()))
    misses = dfb["steps"] - dfb["hits"]
    rec["expected_launches"] = misses * K1_PER_MISS + dfb["hits"] * K1_PER_HIT
    ok = bool(launches == rec["expected_launches"] > 0
              and sr.shape == (224, 224, 3)
              and fin.shape == (224, 224, 3)
              and all(pipe.outputs_finite.values())
              and sr.std() > 0 and fin.std() > 0)
    rec["ok"] = ok
    _say("path", **rec)
    return rec, pipe


# --------------------------------------------------------------- phase 6
def phase_profile(pipe, iters: int = 3):
    """One cache-miss step (GLVControl + UNet input blocks + rest + CFG) and
    one cache-hit step (GLVControl + input blocks) of the 128^2-latent
    RestoreEDM loop, CFG batch 2: wall time per step, device time by kernel
    under torch.profiler, K1's share, and the device's idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from rsvldm_tpu_torch.diffusion.guidance import apply_cfg
    from rsvldm_tpu_torch.models.sdxl.denoiser import ControlDenoiser

    dev, cfg = pipe.device, pipe.sdxl_cfg
    gen = torch.Generator(device=dev).manual_seed(1)
    rnd = lambda *s, dt=torch.float32: torch.randn(s, generator=gen, device=dev,
                                                   dtype=dt)
    cond = dict(crossattn=rnd(2, 77, cfg.context_dim, dt=pipe.dtype),
                vector=rnd(2, cfg.adm_in_channels), control=rnd(2, 4, 128, 128))
    x, sigma = rnd(2, 4, 128, 128), torch.full((2,), 5.0, device=dev)
    den = ControlDenoiser(unet=pipe.unet, control_net=pipe.control)
    steps = {"miss": lambda: apply_cfg(den.rest(den.first(x, sigma, cond), cond,
                                                1.0), 7.5),
             "hit": lambda: den.first(x, sigma, cond).h}
    out = {}
    with torch.inference_mode():
        for name, fn in steps.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / iters
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            avgs = [(e.key, e.self_device_time_total / 1e3, e.count,
                     e.device_type == DeviceType.CUDA)
                    for e in prof.key_averages() if e.self_device_time_total > 0]
            # device-side kernel events only: a CPU op's self device time
            # repeats the time of the kernels it launched
            kernels = [(k, t, c) for k, t, c, on_dev in avgs if on_dev]
            ops = [(k, t, c) for k, t, c, on_dev in avgs if not on_dev]
            dev_ms = sum(t for _, t, _ in kernels)
            k1 = [(t, c) for k, t, c in kernels if "flash_fwd_kernel" in k]
            k1_ms = sum(t for t, _ in k1)
            top = lambda rows: [[k[:80], round(t, 3), c] for k, t, c in
                                sorted(rows, key=lambda r: -r[1])[:10]]
            out[name] = dict(wall_ms=round(wall_ms, 3),
                             device_ms=round(dev_ms, 3),
                             device_idle_share=round(1 - dev_ms / wall_ms, 4),
                             k1_ms=round(k1_ms, 3),
                             k1_launches=sum(c for _, c in k1),
                             k1_share_of_device=round(k1_ms / dev_ms, 4)
                             if dev_ms else None,
                             kernel_launches=sum(c for _, _, c in kernels),
                             top_kernels=top(kernels), top_ops=top(ops))
            _say("profile", step=name, **out[name])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-path", action="store_true",
                    help="stop after the kernel checks (no pipeline run)")
    ap.add_argument("--profile", action="store_true",
                    help="after the path, profile one cache-miss and one "
                         "cache-hit denoising step")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (REPO / "rsvldm_tpu_torch" / "__init__.py").exists():
        print(f"chip_smoke: the rsvldm_tpu_torch package is not beside "
              f"{__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    smi = phase_device()
    phase_build()
    cases = phase_kernels()
    ok = all(c["ok"] for c in cases)
    ok = phase_reference(SEED)["ok"] and ok
    path = None
    if not args.skip_path:
        path, pipe = phase_path(SEED)
        ok = ok and path["ok"]
        if args.profile:
            phase_profile(pipe)
        del pipe

    head = cases[0]
    report = {"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "rsvldm_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "rsvldm_tpu/ops/flash_attention.py:67",
        "launches": path["flash_fwd_launches"] if path else 0,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shapes": [{k: c.get(k) for k in ("case", "shape", "causal", "ms",
                                          "plain_ms", "bound_ms",
                                          "library_ms", "tflops",
                                          "max_abs_err")}
                   for c in cases if "ms" in c],
        "card": smi}]}
    print(json.dumps(report), flush=True)
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    if args.skip_path:
        print("chip_smoke: --skip-path given, no result line", file=sys.stderr)
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
