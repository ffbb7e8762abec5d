"""Super-resolution pipeline (rsvldm_tpu/pipeline.py:
SuperResolutionPipeline.process).

  Stage 1  - SR3 ancestral diffusion on the bicubic-upsampled LR image
  Stage 2a - LLaVA caption of the Stage-1 output (models/vlm/captioner.py),
             skipped with a warning when no captioner is available
  Stage 2b - SDXL + GLVControl RestoreEDM refinement with the first-block
             cache, conditioned on the caption, VAE decode, wavelet colour fix

The uint8 PNG round trip after Stage 1 is kept: the refinement reads the
saved image, as in the JAX pipeline.

Weights, family by family (rsvldm_tpu/pipeline.py:210-305): from
`state_dicts` (one state dict per family, e.g. from
utils/weights.params_from_jax), else from the reference files in
cfg.ckpt_dir (`CHECKPOINTS`: later files overlaid on earlier ones, the
family's prefix stripped; the port's parameter names are the reference
names, so no converter runs), else seeded random init on the device with a
loud warning. Loading fills modules built on the device in the compute
dtype, tensor by tensor (utils/checkpoint.load_checked: missing names and
other shapes raise, extra names are logged). `weight_sources` records each
family's source and `load_s` its seconds. The LLaVA captioner is `captioner`
when given, else LlavaCaptioner.load(cfg.ckpt_dir) (the llava/ shards, the
Llava-next/ PEFT adapter, tokenizer.json, cfg.llava's archives); without
one the caption is empty, as in the JAX pipeline without LLaVA assets.
CLIP tokens come from the BPE tokenizer in <ckpt_dir>/clip_vocab (CLIP-L
padded with EOT, bigG with 0), else from crc32 hash buckets with a warning,
as JAX does.

Stage 1 runs the SR3 ancestral loop (cfg.stage1.sampler "ddpm", T steps)
or DDIM ("ddim", cfg.stage1.ddim_steps with ddim_eta), as the JAX
pipeline's `_stage1_sample_fn`. The loops of Stage 1, the caption decode
and RestoreEDM replay CUDA graphs on the card (utils/graphs.py);
`capture_s` holds each graph's capture seconds of the last run.

Noise comes from a torch.Generator seeded with cfg.seed on the device, or
from `noise`, a callable (name, shape) -> tensor that tests use to replay
the JAX stream. Draws, in the JAX layout: "stage1" [T+1, 1, H, W, 3]
(DDIM: [len(ts)+1, ...], models/sr3/diffusion.ddim_timesteps),
"vae_sample" [N, h, w, 4], "edm_init" [N, h, w, 4], "churn" [steps, N, h,
w, 4].

Not ported yet: folder mode and size_bucket, the tiled VAE.
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
from .models.sr3.diffusion import (SR3Diffusion, ddim_timesteps, sr3_sample,
                                   sr3_sample_ddim)
from .models.sr3.unet import SR3UNet, SR3UNetConfig
from .models.text.clip import (CLIP_L_CONFIG, OPENCLIP_BIGG_CONFIG,
                               CLIPTextTransformer)
from .models.text.conditioner import SDXLConditioner
from .models.vlm.captioner import LlavaCaptioner
from .models.vae.model import SDXL_VAE_CONFIG, AutoencoderKL
from .ops import colorfix
from .ops.image import array_to_pil, load_lr_conditioning, pil_to_array, to_uint8
from .utils.checkpoint import (load_checked, load_torch_state_dict, overlay,
                               strip_prefix)
from .utils.tokenizer import CLIPTokenizer
from .utils.weights import seeded_init_

log = logging.getLogger("rsvldm_torch")

NoiseSource = Callable[[str, tuple], torch.Tensor]

_STAGE2_FILES = ("juggernautXL_v8Rundiffusion.safetensors", "SR-v0Q.ckpt")
# family: (files under ckpt_dir, later overlaid on earlier; prefix stripped)
CHECKPOINTS = {
    "sr3": (("I1000000_E800_gen.pth",), None),
    "control": (_STAGE2_FILES, "model.control_model"),
    "unet": (_STAGE2_FILES, "model.diffusion_model"),
    "vae": (_STAGE2_FILES, "first_stage_model"),
    "clip_l": (_STAGE2_FILES, "conditioner.embedders.0.transformer"),
    "big_g": (_STAGE2_FILES, "conditioner.embedders.1.model"),
}


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
                 captioner: Optional[LlavaCaptioner] = None,
                 llava_load_kw: Optional[dict] = None):
        if cfg.stage1.sampler not in ("ddpm", "ddim"):
            raise ValueError(f"Stage1Config.sampler={cfg.stage1.sampler!r}: "
                             "expected 'ddpm' or 'ddim'")
        if cfg.refine.use_tile_vae:
            raise NotImplementedError("the tiled VAE is not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = compute_dtype(self.device, cfg.params_dtype)
        self.noise = noise or TorchNoise(cfg.seed, self.device)
        self.state_dicts = state_dicts or {}
        # overrides of LlavaCaptioner.load's keywords (llama_cfg,
        # vision_cfg, tokenizer): tests run the real load at tiny width
        self.llava_load_kw = llava_load_kw or {}
        self.weight_sources: Dict[str, object] = {}
        self.load_s: Dict[str, float] = {}
        self._mapped: Dict[str, dict] = {}  # file -> its mapped state dict
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
        self._stage2_loaded = False
        self.timings: Dict[str, float] = {}
        self.capture_s: Dict[str, float] = {}
        self.last_dfb: Optional[dict] = None
        self.outputs_finite: Dict[str, bool] = {}
        self.caption_stats: dict = {}
        self.last_caption = ""
        self.llava = captioner
        self.sr3 = self._build("sr3", SR3UNet, self.sr3_cfg)
        self._mapped.clear()
        self.sr3_diff = SR3Diffusion.from_schedule(
            s1.schedule, s1.steps, s1.linear_start, s1.linear_end)

    # ------------------------------------------------------------ weights
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _files_state_dict(self, family: str):
        """(the family's state dict from its files in cfg.ckpt_dir, the files
        read) or (None, []) when none of them exists. Nothing is read yet:
        the tensors view the mapped files."""
        names, prefix = CHECKPOINTS[family]
        paths = [str(Path(self.cfg.ckpt_dir) / n) for n in names]
        paths = [p for p in paths if Path(p).is_file()]
        if not paths:
            return None, []
        for p in paths:
            if p not in self._mapped:
                self._mapped[p] = load_torch_state_dict(p)
        sd = overlay(*(self._mapped[p] for p in paths))
        if prefix:
            sd = strip_prefix(sd, prefix)
        if family == "vae" and not any(k.startswith("denoise_encoder.") for k in sd):
            # no twin encoder in the files: it starts as the encoder
            # (rsvldm_tpu/utils/convert.py:182-194)
            sd.update({"denoise_encoder." + k[len("encoder."):]: v
                       for k, v in sd.items() if k.startswith("encoder.")})
        return sd, paths

    def _build(self, family: str, cls, mcfg):
        """The family's module on the device in the compute dtype: built
        without allocating (meta), then filled from `state_dicts`, else from
        its files, else by seeded random init."""
        self._sync()
        t0 = time.perf_counter()
        with torch.device("meta"):
            module = cls(mcfg)
        module = module.to(dtype=self.dtype).to_empty(device=self.device)
        sd = self.state_dicts.get(family)
        if sd is not None:
            load_checked(module, sd, family)
            self.weight_sources[family] = "state_dict"
        else:
            sd, paths = self._files_state_dict(family)
            if sd is not None:
                load_checked(module, sd, f"{family} ({', '.join(paths)})")
                self.weight_sources[family] = paths
            else:
                seeded_init_(module, family, self.device)
                self.weight_sources[family] = "seeded"
        self._sync()
        self.load_s[family] = time.perf_counter() - t0
        return module.eval().requires_grad_(False)

    def ensure_stage2(self):
        """Stage-2 weights, the CLIP tokenizer and the captioner, on first
        use."""
        if self._stage2_loaded:
            return
        self.unet = self._build("unet", ControlledUNet, self.sdxl_cfg)
        self.control = self._build("control", GLVControl, self.sdxl_cfg)
        self.vae = self._build("vae", AutoencoderKL, self.vae_cfg)
        self.clip_l = self._build("clip_l", CLIPTextTransformer, self.clip_l_cfg)
        self.big_g = self._build("big_g", CLIPTextTransformer, self.big_g_cfg)
        self._mapped.clear()
        tok_dir = Path(self.cfg.ckpt_dir) / "clip_vocab"
        try:
            self.tokenizer = CLIPTokenizer.from_dir(str(tok_dir))
        except FileNotFoundError:
            log.warning("CLIP tokenizer assets missing (%s): hash-bucket "
                        "tokens (smoke mode)", tok_dir)
            self.tokenizer = None
        if self.cfg.no_llava:
            self.llava = None
        elif self.llava is not None:
            self.weight_sources["llava"] = "captioner"
        else:
            self._load_llava()
        self._stage2_loaded = True

    def _load_llava(self):
        llava = self.cfg.llava
        kw = {"quant": llava.quant or None, "device": self.device,
              "dtype": self.dtype, "lora_npz": llava.lora_npz or None,
              "projector_npz": llava.projector_npz or None,
              **self.llava_load_kw}
        try:
            self.llava = LlavaCaptioner.load(self.cfg.ckpt_dir, **kw)
        except (FileNotFoundError, KeyError, ValueError) as e:
            # assets partial or malformed, as the JAX pipeline treats them
            log.warning("LLaVA load failed (%s): captioning disabled", e)
            self.llava = None
        if self.llava is not None:
            stats = self.llava.load_stats
            self.weight_sources["llava"] = stats["files"]
            self.load_s["llava"] = sum(v for k, v in stats.items()
                                       if k.endswith("_s"))

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
        """Bicubic x upscale + the SR3 ancestral loop or DDIM; uint8 HWC."""
        cond = torch.from_numpy(load_lr_conditioning(image_path, self.cfg.upscale)[None])
        s1, T = self.cfg.stage1, self.sr3_diff.buffers.num_timesteps
        rows = (len(ddim_timesteps(T, s1.ddim_steps)) if s1.sampler == "ddim"
                else T) + 1
        noise = self.noise("stage1", (rows, *cond.shape))
        stats: dict = {}
        if s1.sampler == "ddim":
            x = sr3_sample_ddim(self.sr3_diff, self.sr3, cond.to(self.device),
                                noise, s1.ddim_steps, s1.ddim_eta, stats=stats)
        else:
            x = sr3_sample(self.sr3_diff, self.sr3, cond.to(self.device), noise,
                           stats=stats)
        self.capture_s["stage1"] = stats["capture_s"]
        self.outputs_finite["stage1"] = bool(torch.isfinite(x).all())
        return to_uint8(x[0].cpu().numpy())

    # ----------------------------------------------------------- stage 2a
    def run_caption(self, sr_image) -> str:
        """LLaVA caption of the Stage-1 image (PIL); empty with no_llava or
        without a captioner. caption_stats: prompt length, prefill and
        decode seconds, decode steps."""
        if self.cfg.no_llava:
            return ""
        self.ensure_stage2()
        if self.llava is None:
            log.warning("LLaVA assets not loaded: skipping captioning "
                        "(equivalent of no_llava)")
            return ""
        with self._timed("caption"):
            caption = self.llava.caption(sr_image, self.cfg.llava)
        self.caption_stats = dict(self.llava.last_stats)
        self.capture_s["caption"] = self.caption_stats.get("capture_s", 0.0)
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

    def _tokens(self, texts):
        """(CLIP-L tokens padded with EOT, bigG tokens padded with 0), [N, 77]
        on the device; without clip_vocab both are the hash tokens."""
        if self.tokenizer is None:
            tl = tg = hash_tokens(texts, self.clip_l_cfg.vocab_size)
        else:
            tl = self.tokenizer(texts, pad_id=None)
            tg = self.tokenizer(texts, pad_id=0)
        to = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(self.device)
        return to(tl), to(tg)

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
            tl_c, tg_c = self._tokens(texts_c)
            tl_u, tg_u = self._tokens([r.n_prompt] * len(texts_c))
            conditioner = SDXLConditioner(self.clip_l, self.big_g)
            cond, uc = conditioner.paired(tl_c, tg_c, tl_u, tg_u, _nhwc(z_lq))
        with self._timed("sampling"):
            shape = tuple(cond["control"].shape)
            noise = self.noise("edm_init", shape).to(self.device)
            churn = (self.noise("churn", (scfg.num_steps, *shape)).to(self.device)
                     if scfg.s_churn > 0 else None)
            denoiser = ControlDenoiser(unet=self.unet, control_net=self.control)
            stats: dict = {}
            z, aux = restore_edm_sample(denoiser, cond, uc, noise,
                                        _nhwc(z_stage1), scfg,
                                        churn_noise=churn, return_aux=True,
                                        stats=stats)
        self.capture_s.update({f"sampling_{k}": v
                               for k, v in stats["capture_s"].items()})
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
