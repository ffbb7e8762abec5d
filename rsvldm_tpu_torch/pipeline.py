"""Super-resolution pipeline (rsvldm_tpu/pipeline.py:
SuperResolutionPipeline.process).

  Stage 1  - SR3 ancestral diffusion on the bicubic-upsampled LR image
  Stage 2a - LLaVA caption of the Stage-1 output (models/vlm/captioner.py),
             skipped with a warning when no captioner is available
  Stage 2b - SDXL + GLVControl RestoreEDM refinement with the first-block
             cache, conditioned on the caption, VAE decode, wavelet colour fix

The uint8 PNG round trip after Stage 1 is kept: the refinement reads the
saved image, as in the JAX pipeline. Weights come from `state_dicts` (one
state dict per family, e.g. from utils/weights.params_from_jax); a family
without one gets seeded random init on the device with a loud warning
(checkpoint loading is not ported yet). Noise comes from a torch.Generator
seeded with cfg.seed on the device, or from `noise`, a callable
(name, shape) -> tensor that tests use to replay the JAX stream. Draws, in
the JAX layout: "stage1" [T+1, 1, H, W, 3], "vae_sample" [N, h, w, 4],
"edm_init" [N, h, w, 4], "churn" [steps, N, h, w, 4].

The captioner comes from `captioner` (an LlavaCaptioner built by the
caller, e.g. LlavaCaptioner.from_state_dict or .seeded) or from
LlavaCaptioner.load(cfg.ckpt_dir), which finds nothing to read yet; without
one the caption is empty, as in the JAX pipeline without LLaVA assets.

Not ported yet: reading checkpoints (every family), folder mode and
size_bucket, the tiled VAE, the SR3 DDIM sampler, the CLIP BPE tokenizer
(the crc32 hash-bucket tokens below are what the JAX pipeline uses when
ckpt_dir/clip_vocab is missing).
"""

from __future__ import annotations

import contextlib
import logging
import time
import zlib
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch
from PIL import Image

from .config import PipelineConfig
from .device import compute_dtype, resolve_device
from .diffusion.samplers import RestoreEDMConfig, restore_edm_sample
from .models.sdxl.control import ControlledUNet, GLVControl
from .models.sdxl.denoiser import ControlDenoiser
from .models.sdxl.unet import SDXLUNetConfig
from .models.sr3.diffusion import SR3Diffusion, sr3_sample
from .models.sr3.unet import SR3UNet, SR3UNetConfig
from .models.text.clip import (CLIP_L_CONFIG, OPENCLIP_BIGG_CONFIG,
                               CLIPTextTransformer)
from .models.text.conditioner import SDXLConditioner
from .models.vlm.captioner import LlavaCaptioner
from .models.vae.model import SDXL_VAE_CONFIG, AutoencoderKL
from .ops import colorfix
from .ops.image import array_to_pil, load_lr_conditioning, pil_to_array, to_uint8
from .utils.weights import seeded_init_

log = logging.getLogger("rsvldm_torch")

NoiseSource = Callable[[str, tuple], torch.Tensor]


class TorchNoise:
    """Unit normals from one torch.Generator on the device."""

    def __init__(self, seed: int, device: torch.device):
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def __call__(self, name: str, shape: tuple) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device)


class ReplayNoise:
    """Replays given arrays by draw name, in order (e.g. the JAX stream)."""

    def __init__(self, draws: Dict[str, list]):
        self.draws = {k: list(v) for k, v in draws.items()}

    def __call__(self, name: str, shape: tuple) -> torch.Tensor:
        arr = np.array(self.draws[name].pop(0), np.float32)
        if arr.shape != tuple(shape):
            raise ValueError(f"replayed {name} draw has shape {arr.shape}, "
                             f"expected {tuple(shape)}")
        return torch.from_numpy(arr)


def hash_tokens(texts, vocab: int) -> np.ndarray:
    """Deterministic hash-bucket CLIP tokens [N, 77]: BOS 1, crc32 buckets
    of up to 75 lower-cased words, EOT vocab-1, zero padding."""
    out = np.zeros((len(texts), 77), np.int64)
    for i, t in enumerate(texts):
        words = t.lower().split()[:75]
        out[i, 0] = 1
        for j, w in enumerate(words):
            out[i, j + 1] = (zlib.crc32(w.encode()) % (vocab - 3)) + 2
        out[i, len(words) + 1] = vocab - 1
    return out


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


class SuperResolutionPipeline:
    def __init__(self, cfg: PipelineConfig, device: str | torch.device | None = None,
                 model_cfgs: Optional[Dict] = None,
                 state_dicts: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                 noise: Optional[NoiseSource] = None,
                 captioner: Optional[LlavaCaptioner] = None):
        if cfg.stage1.sampler != "ddpm":
            raise NotImplementedError("only the ddpm Stage-1 sampler is ported")
        if cfg.refine.use_tile_vae:
            raise NotImplementedError("the tiled VAE is not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = compute_dtype(self.device, cfg.params_dtype)
        self.noise = noise or TorchNoise(cfg.seed, self.device)
        self.state_dicts = state_dicts or {}
        mc = model_cfgs or {}
        s1 = cfg.stage1
        self.sr3_cfg = mc.get("sr3") or SR3UNetConfig(
            inner_channel=s1.inner_channel, channel_mults=tuple(s1.channel_mults),
            attn_res=tuple(s1.attn_res), res_blocks=s1.res_blocks,
            image_size=s1.image_size)
        self.sdxl_cfg = mc.get("sdxl") or SDXLUNetConfig()
        self.vae_cfg = mc.get("vae") or SDXL_VAE_CONFIG
        self.clip_l_cfg = mc.get("clip_l") or CLIP_L_CONFIG
        self.big_g_cfg = mc.get("big_g") or OPENCLIP_BIGG_CONFIG
        self.sr3 = self._build("sr3", SR3UNet, self.sr3_cfg)
        self.sr3_diff = SR3Diffusion.from_schedule(
            s1.schedule, s1.steps, s1.linear_start, s1.linear_end)
        self._stage2_loaded = False
        self.timings: Dict[str, float] = {}
        self.last_dfb: Optional[dict] = None
        self.outputs_finite: Dict[str, bool] = {}
        self.caption_stats: dict = {}
        self.last_caption = ""
        self.llava = None
        if not cfg.no_llava:
            self.llava = captioner
            if captioner is None:
                try:
                    self.llava = LlavaCaptioner.load(
                        cfg.ckpt_dir, quant=cfg.llava.quant or None)
                except Exception as e:  # assets missing or unreadable
                    log.warning("LLaVA load failed (%s): captioning disabled", e)

    # ------------------------------------------------------------ weights
    def _build(self, family: str, cls, mcfg):
        """The family's module on the device in the compute dtype: built
        without allocating (meta), then filled from its state dict
        (strict) or by seeded random init."""
        with torch.device("meta"):
            module = cls(mcfg)
        module = module.to(dtype=self.dtype).to_empty(device=self.device)
        sd = self.state_dicts.get(family)
        if sd is not None:
            module.load_state_dict(sd, strict=True)
        else:
            seeded_init_(module, family, self.device)
        return module.eval().requires_grad_(False)

    def ensure_stage2(self):
        """Stage-2 weights, built on first use."""
        if self._stage2_loaded:
            return
        self.unet = self._build("unet", ControlledUNet, self.sdxl_cfg)
        self.control = self._build("control", GLVControl, self.sdxl_cfg)
        self.vae = self._build("vae", AutoencoderKL, self.vae_cfg)
        self.clip_l = self._build("clip_l", CLIPTextTransformer, self.clip_l_cfg)
        self.big_g = self._build("big_g", CLIPTextTransformer, self.big_g_cfg)
        log.warning("CLIP BPE tokenizer not ported: hash-bucket tokens "
                    "(smoke mode)")
        self._stage2_loaded = True

    @contextlib.contextmanager
    def _timed(self, name: str):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings[name] = time.perf_counter() - t0

    # ------------------------------------------------------------ stage 1
    @torch.inference_mode()
    def run_stage1(self, image_path: str) -> np.ndarray:
        """Bicubic x upscale + the SR3 ancestral loop; uint8 HWC."""
        cond = torch.from_numpy(load_lr_conditioning(image_path, self.cfg.upscale)[None])
        noise = self.noise("stage1", (self.sr3_diff.buffers.num_timesteps + 1,
                                      *cond.shape))
        x = sr3_sample(self.sr3_diff, self.sr3, cond.to(self.device), noise)
        self.outputs_finite["stage1"] = bool(torch.isfinite(x).all())
        return to_uint8(x[0].cpu().numpy())

    # ----------------------------------------------------------- stage 2a
    def run_caption(self, sr_image) -> str:
        """LLaVA caption of the Stage-1 image (PIL); empty with no_llava or
        without a captioner. caption_stats: prompt length, prefill and
        decode seconds, decode steps."""
        if self.cfg.no_llava:
            return ""
        if self.llava is None:
            log.warning("LLaVA assets not loaded: skipping captioning "
                        "(equivalent of no_llava)")
            return ""
        with self._timed("caption"):
            caption = self.llava.caption(sr_image, self.cfg.llava)
        self.caption_stats = dict(self.llava.last_stats)
        self.last_caption = caption
        log.info("stage2a caption (%.2fs): %s", self.timings["caption"],
                 caption[:120])
        return caption

    # ----------------------------------------------------------- stage 2b
    def _make_sampler_cfg(self) -> RestoreEDMConfig:
        r = self.cfg.refine
        return RestoreEDMConfig(
            num_steps=r.edm_steps, cfg_scale=r.s_cfg,
            cfg_scale_start=r.spt_linear_cfg, use_linear_cfg=r.linear_cfg,
            restore_cfg=r.s_stage1, s_churn=r.s_churn, s_noise=r.s_noise,
            control_scale=r.s_stage2,
            use_linear_control_scale=r.linear_s_stage2,
            control_scale_start=r.spt_linear_s_stage2,
            img_threshold=r.img_threshold, dec_img=1.0)

    def _tokens(self, texts) -> torch.Tensor:
        return torch.from_numpy(hash_tokens(texts, self.clip_l_cfg.vocab_size)).to(self.device)

    def _refine_core(self, x: torch.Tensor, texts_c):
        """x [N, H, W, 3] in [-1, 1] -> (samples, x_stage1), both [N, H, W, 3]
        fp32 on the device."""
        r = self.cfg.refine
        scfg = self._make_sampler_cfg()
        vae = self.vae
        with self._timed("vae_prep"):
            x = _nchw(x.to(self.device))
            z_lq = vae.encode_with_denoise(x)
            x_stage1 = vae.decode(z_lq)
            eps = self.noise("vae_sample", tuple(_nhwc(z_lq).shape))
            z_stage1 = vae.encode(x_stage1, noise=_nchw(eps.to(self.device)))
        with self._timed("conditioning"):
            tc = self._tokens(texts_c)
            tu = self._tokens([r.n_prompt] * len(texts_c))
            conditioner = SDXLConditioner(self.clip_l, self.big_g)
            cond, uc = conditioner.paired(tc, tc, tu, tu, _nhwc(z_lq))
        with self._timed("sampling"):
            shape = tuple(cond["control"].shape)
            noise = self.noise("edm_init", shape).to(self.device)
            churn = (self.noise("churn", (scfg.num_steps, *shape)).to(self.device)
                     if scfg.s_churn > 0 else None)
            denoiser = ControlDenoiser(unet=self.unet, control_net=self.control)
            z, aux = restore_edm_sample(denoiser, cond, uc, noise,
                                        _nhwc(z_stage1), scfg,
                                        churn_noise=churn, return_aux=True)
        log.info("first-block cache (batch %d): %d/%d steps skipped "
                 "middle+decoder", x.shape[0], aux["cache_hits"], aux["num_steps"])
        self.last_dfb = {"hits": aux["cache_hits"], "steps": aux["num_steps"],
                         "trace": aux["hit_trace"]}
        with self._timed("decode"):
            samples = vae.decode(_nchw(z))
        return _nhwc(samples), _nhwc(x_stage1)

    def _colorfix(self, samples, x_stage1):
        kind = self.cfg.refine.color_fix_type
        if kind == "Wavelet":
            return colorfix.wavelet_reconstruction(samples, x_stage1)
        if kind == "AdaIn":
            return colorfix.adaptive_instance_normalization(samples, x_stage1)
        return samples

    @torch.inference_mode()
    def run_refinement(self, sr_image, caption: str):
        """Stage-2b on the saved Stage-1 image (PIL) -> PIL image(s)."""
        self.ensure_stage2()
        r = self.cfg.refine
        x, h0, w0 = pil_to_array(sr_image, upscale=1, min_size=r.min_size)
        x = torch.from_numpy(x)[None]
        if r.num_samples > 1:
            x = x.repeat(r.num_samples, 1, 1, 1)
        texts = [" ".join([caption, r.a_prompt])] * max(r.num_samples, 1)
        samples, x_stage1 = self._refine_core(x, texts)
        with self._timed("colorfix"):
            samples = self._colorfix(samples, x_stage1)
            self.outputs_finite["refined"] = bool(torch.isfinite(samples).all())
            samples = samples.cpu().numpy()
        pils = [array_to_pil(samples[i], h0, w0) for i in range(samples.shape[0])]
        return pils[0] if len(pils) == 1 else pils

    # -------------------------------------------------------- entry point
    def process(self, image_path: str | None = None):
        """Stage 1 -> sr3_<stem>.png -> Stage 2a caption -> Stage 2b ->
        <stem>_final_<i>.png."""
        path = Path(image_path or self.cfg.input_img)
        out_dir = Path(self.cfg.output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        with self._timed("stage1"):
            sr_np = self.run_stage1(str(path))
        sr_pil = Image.fromarray(sr_np)
        sr_pil.save(out_dir / f"sr3_{path.stem}.png")
        if self.cfg.stage1_only:
            return sr_pil
        caption = self.run_caption(sr_pil)
        t0 = time.perf_counter()
        final = self.run_refinement(sr_pil, caption)
        self.timings["stage2b"] = time.perf_counter() - t0
        finals = final if isinstance(final, list) else [final]
        for i, f in enumerate(finals):
            f.save(out_dir / f"{path.stem}_final_{i}.png")
        return finals[0]
