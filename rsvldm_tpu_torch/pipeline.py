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
and RestoreEDM replay CUDA graphs on the card (utils/graphs.py); each
loop's tensors and graphs are kept per input shape and sampler config
(`loop_graphs`, and the captioner's `decode_graphs`), as the JAX pipeline
keeps one jitted program per shape, so a later call of a kept shape
captures nothing. `capture_s` holds each graph's capture seconds of the
last run (0 for a kept graph).

Folder mode (JAX pipeline.py:339-398, 540-605, 712-848): `run_stage1_batch`
runs one batched Stage-1 loop per conditioning shape, `run_caption_batch`
one batched decode, `run_refinement_batch` one batched RestoreEDM loop over
images padded to a shared `size_bucket` multiple (`bucket_pad`), each
cropped and colour-fixed on its own; `ImageBatchProcessor` drives them over
a folder (python -m rsvldm_tpu_torch.infer_dir).

Noise comes from a torch.Generator seeded with cfg.seed on the device, or
from `noise`, a callable (name, shape) -> tensor that tests use to replay
the JAX stream. Draws, in the JAX layout: "stage1" [T+1, 1, H, W, 3]
(DDIM: [len(ts)+1, ...], models/sr3/diffusion.ddim_timesteps),
"vae_sample" [N, h, w, 4], "edm_init" [N, h, w, 4], "churn" [steps, N, h,
w, 4]; a batched Stage 1 draws one "stage1" [rows, N, H, W, 3] per group,
a batched refinement each of the others with N images.

The tiled VAE (cfg.refine.use_tile_vae, JAX pipeline.py:607-678): when the
image's shorter side exceeds encoder_tile_size, the VAE preparation and the
final decode run over tiles (models/vae/tiled.py): the twin encoder and the
decoder tiled, then the encoder's moments tiled and the posterior sampled
once on the stitched moments with the "vae_sample" draw. A batched
refinement whose bucket-padded shape would tile refines image by image,
as JAX does, since the tile axis is the statistics pool of one image.
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
from .models.vae import tiled
from .models.vae.model import SDXL_VAE_CONFIG, AutoencoderKL, DiagonalGaussian
from .ops import colorfix
from .ops.image import (array_to_pil, load_lr_conditioning, pil_to_array,
                        round_to_multiple, to_uint8)
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


def bucket_pad(x: np.ndarray, bucket: int) -> np.ndarray:
    """Edge-pad an HWC image up to the next `bucket` multiple in H and W
    (JAX pipeline.py:69-80), so that images of several sizes share one
    kept sampling loop; callers crop the decode back."""
    if not bucket:
        return x
    h, w = x.shape[0], x.shape[1]
    hb = -(-h // bucket) * bucket
    wb = -(-w // bucket) * bucket
    if (hb, wb) == (h, w):
        return x
    return np.pad(x, ((0, hb - h), (0, wb - w), (0, 0)), mode="edge")


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
        # the Stage-1 and RestoreEDM loops' tensors and graphs, per input
        # shape and sampler config (models/sr3/diffusion._run, EDMLoop)
        self.loop_graphs: dict = {}
        self.stage1_groups: list = []  # run_stage1_batch's, per group
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
        self.denoiser = ControlDenoiser(unet=self.unet, control_net=self.control)
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
              "draft_dir": llava.draft_dir or None, "spec_k": llava.spec_k,
              "self_draft_layers": llava.self_draft_layers,
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
    def _stage1(self, conds: np.ndarray) -> list:
        """conds [N, H, W, 3] -> N uint8 HWC images: one SR3 ancestral or
        DDIM loop over the batch, kept per shape in `loop_graphs`."""
        cond = torch.from_numpy(conds)
        s1, T = self.cfg.stage1, self.sr3_diff.buffers.num_timesteps
        rows = (len(ddim_timesteps(T, s1.ddim_steps)) if s1.sampler == "ddim"
                else T) + 1
        noise = self.noise("stage1", (rows, *cond.shape))
        stats: dict = {}
        kw = dict(stats=stats, graph_cache=self.loop_graphs)
        if s1.sampler == "ddim":
            x = sr3_sample_ddim(self.sr3_diff, self.sr3, cond.to(self.device),
                                noise, s1.ddim_steps, s1.ddim_eta, **kw)
        else:
            x = sr3_sample(self.sr3_diff, self.sr3, cond.to(self.device), noise,
                           **kw)
        self.capture_s["stage1"] = stats["capture_s"]
        self.outputs_finite["stage1"] = bool(torch.isfinite(x).all())
        x = x.cpu().numpy()
        return [to_uint8(x[i]) for i in range(x.shape[0])]

    @torch.inference_mode()
    def run_stage1(self, image_path: str) -> np.ndarray:
        """Bicubic x upscale + the SR3 ancestral loop or DDIM; uint8 HWC."""
        return self._stage1(load_lr_conditioning(image_path,
                                                 self.cfg.upscale)[None])[0]

    @torch.inference_mode()
    def run_stage1_batch(self, image_paths) -> list:
        """Folder Stage 1 (JAX run_stage1_batch, pipeline.py:339-398, on
        one card): the images grouped by conditioning shape, in order of
        first appearance, each group one batched loop and one "stage1"
        draw. `stage1_groups` records each group's size, shape, seconds
        and capture seconds. Returns uint8 HWC images in input order."""
        conds = [load_lr_conditioning(str(p), self.cfg.upscale)
                 for p in image_paths]
        groups: dict = {}
        for i, c in enumerate(conds):
            groups.setdefault(c.shape, []).append(i)
        results: list = [None] * len(conds)
        self.stage1_groups = []
        for shape, idxs in groups.items():
            self._sync()
            t0 = time.perf_counter()
            for i, out in zip(idxs, self._stage1(np.stack([conds[i]
                                                           for i in idxs]))):
                results[i] = out
            self.stage1_groups.append(dict(
                n=len(idxs), shape=list(shape), seconds=time.perf_counter() - t0,
                capture_s=self.capture_s["stage1"]))
        return results

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

    def run_caption_batch(self, sr_images) -> list:
        """Captions of several Stage-1 images (PIL) in one batched decode
        (LlavaCaptioner.caption_batch); empty strings with no_llava or
        without a captioner. caption_stats as `run_caption`'s, with the
        prompt lengths and rows."""
        if self.cfg.no_llava:
            return [""] * len(sr_images)
        self.ensure_stage2()
        if self.llava is None:
            log.warning("LLaVA assets not loaded: skipping captioning "
                        "(equivalent of no_llava)")
            return [""] * len(sr_images)
        with self._timed("caption"):
            captions = self.llava.caption_batch(sr_images, self.cfg.llava)
        self.caption_stats = dict(self.llava.last_stats)
        self.capture_s["caption"] = self.caption_stats.get("capture_s", 0.0)
        log.info("stage2a captions of %d images (%.2fs)", len(captions),
                 self.timings["caption"])
        return captions

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

    def _use_tiles(self, hw) -> bool:
        r = self.cfg.refine
        return r.use_tile_vae and min(hw) > r.encoder_tile_size

    def _vae_prep(self, x: torch.Tensor):
        """x [N, 3, H, W] -> (z_lq, x_stage1, z_stage1): the twin encoder,
        the decode, and the encoder's posterior sampled with the
        "vae_sample" draw; tiled when `_use_tiles` (one image)."""
        vae, r = self.vae, self.cfg.refine
        if not self._use_tiles(x.shape[2:]):
            z_lq = vae.encode_with_denoise(x)
            x_stage1 = vae.decode(z_lq)
            eps = self.noise("vae_sample", tuple(_nhwc(z_lq).shape))
            return z_lq, x_stage1, vae.encode(x_stage1,
                                              noise=_nchw(eps.to(self.device)))
        z_lq = tiled.tiled_encode(vae.encode_with_denoise, x,
                                  tile=r.encoder_tile_size)
        x_stage1 = tiled.tiled_decode(vae.decode, z_lq, tile=r.decoder_tile_size)
        # the moments tiled, the posterior sampled once on the stitched ones
        moments = tiled.tiled_encode(lambda t: vae.quant_conv(vae.encoder(t)),
                                     x_stage1, tile=r.encoder_tile_size)
        eps = self.noise("vae_sample", tuple(_nhwc(z_lq).shape))
        post = DiagonalGaussian(moments.float())
        z_stage1 = vae.cfg.scale_factor * post.sample(_nchw(eps.to(self.device)))
        return z_lq, x_stage1, z_stage1

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        """The final decode, tiled when `_use_tiles` at 8x z's extent."""
        if self._use_tiles((8 * z.shape[2], 8 * z.shape[3])):
            return tiled.tiled_decode(self.vae.decode, z,
                                      tile=self.cfg.refine.decoder_tile_size)
        return self.vae.decode(z)

    def _refine_core(self, x: torch.Tensor, texts_c):
        """x [N, H, W, 3] in [-1, 1] -> (samples, x_stage1), both [N, H, W, 3]
        fp32 on the device."""
        r = self.cfg.refine
        scfg = self._make_sampler_cfg()
        with self._timed("vae_prep"):
            z_lq, x_stage1, z_stage1 = self._vae_prep(_nchw(x.to(self.device)))
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
            stats: dict = {}
            z, aux = restore_edm_sample(self.denoiser, cond, uc, noise,
                                        _nhwc(z_stage1), scfg,
                                        churn_noise=churn, return_aux=True,
                                        stats=stats,
                                        graph_cache=self.loop_graphs)
        self.capture_s.update({f"sampling_{k}": v
                               for k, v in stats["capture_s"].items()})
        log.info("first-block cache (batch %d): %d/%d steps skipped "
                 "middle+decoder", x.shape[0], aux["cache_hits"], aux["num_steps"])
        self.last_dfb = {"hits": aux["cache_hits"], "steps": aux["num_steps"],
                         "trace": aux["hit_trace"]}
        with self._timed("decode"):
            samples = self._decode(_nchw(z))
        return _nhwc(samples), _nhwc(x_stage1)

    def _colorfix(self, samples, x_stage1):
        kind = self.cfg.refine.color_fix_type
        if kind == "Wavelet":
            return colorfix.wavelet_reconstruction(samples, x_stage1)
        if kind == "AdaIn":
            return colorfix.adaptive_instance_normalization(samples, x_stage1)
        return samples

    def _finish(self, samples, x_stage1, metas):
        """Crop each image of the batch to its real extent, colour-fix it,
        and resize it back to its size before rounding: PIL images."""
        outs, finite = [], True
        with self._timed("colorfix"):
            for i, (h_real, w_real, h0, w0) in enumerate(metas):
                s_i = self._colorfix(samples[i:i + 1, :h_real, :w_real],
                                     x_stage1[i:i + 1, :h_real, :w_real])
                finite = finite and bool(torch.isfinite(s_i).all())
                outs.append(array_to_pil(s_i[0].cpu().numpy(), h0, w0))
        self.outputs_finite["refined"] = finite
        return outs

    @torch.inference_mode()
    def run_refinement(self, sr_image, caption: str, use_bucket: bool = True):
        """Stage-2b on the saved Stage-1 image (PIL) -> PIL image(s).
        use_bucket: edge-pad to the next cfg.refine.size_bucket multiple
        (`bucket_pad`), so that a folder's sizes share a kept loop, and
        crop after the decode; process() passes False, as JAX does."""
        self.ensure_stage2()
        r = self.cfg.refine
        x, h0, w0 = pil_to_array(sr_image, upscale=1, min_size=r.min_size)
        h_real, w_real = x.shape[0], x.shape[1]
        if use_bucket:
            x = bucket_pad(x, r.size_bucket)
        x = torch.from_numpy(np.ascontiguousarray(x))[None]
        n = max(r.num_samples, 1)
        if r.num_samples > 1:
            x = x.repeat(r.num_samples, 1, 1, 1)
        texts = [" ".join([caption, r.a_prompt])] * n
        samples, x_stage1 = self._refine_core(x, texts)
        pils = self._finish(samples, x_stage1, [(h_real, w_real, h0, w0)] * n)
        return pils[0] if len(pils) == 1 else pils

    @torch.inference_mode()
    def run_refinement_batch(self, items) -> list:
        """Batched Stage-2b (JAX run_refinement_batch, pipeline.py:540-605)
        over (sr_pil, caption) items: each image padded by edge to the
        batch's largest size_bucket (else 64) multiple, one _refine_core
        with one text per row, then each cropped and colour-fixed on its
        own. With num_samples != 1 or one item, image by image through
        run_refinement; so too when the padded shape would take the tiled
        VAE, whose tile axis pools one image's statistics (JAX
        pipeline.py:562-574). Returns PIL images in order."""
        self.ensure_stage2()
        r = self.cfg.refine
        if r.num_samples != 1 or len(items) == 1:
            return [self.run_refinement(p, c) for p, c in items]
        xs, metas = [], []
        for pil, _ in items:
            x, h0, w0 = pil_to_array(pil, upscale=1, min_size=r.min_size)
            xs.append(x)
            metas.append((x.shape[0], x.shape[1], h0, w0))
        bucket = r.size_bucket or 64
        hb = max(-(-m[0] // bucket) * bucket for m in metas)
        wb = max(-(-m[1] // bucket) * bucket for m in metas)
        if self._use_tiles((hb, wb)):
            return [self.run_refinement(p, c) for p, c in items]
        x = torch.from_numpy(np.stack([
            np.pad(x, ((0, hb - x.shape[0]), (0, wb - x.shape[1]), (0, 0)),
                   mode="edge") for x in xs]))
        samples, x_stage1 = self._refine_core(
            x, [" ".join([cap, r.a_prompt]) for _, cap in items])
        return self._finish(samples, x_stage1, metas)

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
        final = self.run_refinement(sr_pil, caption, use_bucket=False)
        self.timings["stage2b"] = time.perf_counter() - t0
        finals = final if isinstance(final, list) else [final]
        for i, f in enumerate(finals):
            f.save(out_dir / f"{path.stem}_final_{i}.png")
        return finals[0]


IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp"}


class ImageBatchProcessor:
    """Folder inference (JAX ImageBatchProcessor, pipeline.py:712-848): the
    images of cfg.image_dir, sorted, through batched Stage 1 (one loop per
    conditioning shape), batched captions (`caption_batch` images a decode)
    and batched refinement (`refine_batch` images a loop, grouped by
    bucketed shape), writing <output_dir>/sr3_output/sr3_<stem>.png and
    <output_dir>/output/<stem>_final_<i>.png.

    A batched stage that raises falls back to image-by-image work, as in
    JAX; each fallback taken is recorded in `fallbacks` as (stage, error).
    `statuses` has each image's "ok", "stage1" (stage1_only) or "error:
    ...". `timings` has the seconds of each stage and of the whole run;
    `stage1_groups`, `caption_batches` and `refine_chunks` the figures of
    each batched call (sizes, seconds, capture seconds, DFB trace)."""

    def __init__(self, cfg: PipelineConfig, device: str | torch.device | None = None,
                 caption_batch: int = 8, refine_batch: int = 4, **pipe_kw):
        self.cfg = cfg
        self.caption_batch = max(int(caption_batch), 1)
        self.refine_batch = max(int(refine_batch), 1)
        self.pipe = SuperResolutionPipeline(cfg, device=device, **pipe_kw)
        self.fallbacks: list = []
        self.statuses: dict = {}
        self.timings: Dict[str, float] = {}
        self.caption_batches: list = []
        self.refine_chunks: list = []

    def _fallback(self, stage: str, e: Exception):
        log.exception("batched %s failed (%s); falling back to per-image",
                      stage, e)
        self.fallbacks.append((stage, f"{type(e).__name__}: {e}"))

    def _now(self) -> float:
        self.pipe._sync()
        return time.perf_counter()

    def run(self):
        """[(file name, status)] for every image of the folder, in order."""
        pipe, cfg = self.pipe, self.cfg
        t_run = self._now()
        out_dir = Path(cfg.output_dir)
        final_dir, sr3_dir = out_dir / "output", out_dir / "sr3_output"
        final_dir.mkdir(parents=True, exist_ok=True)
        sr3_dir.mkdir(parents=True, exist_ok=True)
        images = sorted(p for p in Path(cfg.image_dir).iterdir()
                        if p.suffix.lower() in IMAGE_EXTS)
        self.fallbacks, self.statuses = [], {}
        self.caption_batches, self.refine_chunks = [], []

        t0 = self._now()
        stage1_out: dict = {}
        if len(images) > 1:
            try:
                stage1_out = dict(zip(images, pipe.run_stage1_batch(images)))
            except Exception as e:
                self._fallback("stage1", e)
        self.timings["stage1"] = self._now() - t0

        # one batched decode serves up to caption_batch images
        t0 = self._now()
        captions: dict = {}
        if (stage1_out and not cfg.stage1_only and not cfg.no_llava
                and len(images) > 1):
            try:
                pipe.ensure_stage2()
                if pipe.llava is not None:
                    todo = [p for p in images if stage1_out.get(p) is not None]
                    pils = [Image.fromarray(stage1_out[p]) for p in todo]
                    for i in range(0, len(todo), self.caption_batch):
                        caps = pipe.run_caption_batch(
                            pils[i:i + self.caption_batch])
                        captions.update(zip(todo[i:i + self.caption_batch], caps))
                        self.caption_batches.append(dict(
                            pipe.caption_stats, n=len(caps),
                            seconds=pipe.timings["caption"]))
            except Exception as e:
                # the captioned prefix is kept; the loop below captions the rest
                self._fallback("caption", e)
        self.timings["caption"] = self._now() - t0

        # Stage 1 and captions per image where the batched stages left any
        t0 = self._now()
        ready: list = []   # (path, sr_pil, caption)
        for p in images:
            try:
                sr_np = stage1_out.get(p)
                if sr_np is None:
                    sr_np = pipe.run_stage1(str(p))
                sr_pil = Image.fromarray(sr_np)
                sr_pil.save(sr3_dir / f"sr3_{p.stem}.png")
                if cfg.stage1_only:
                    self.statuses[p] = "stage1"
                    continue
                caption = captions.get(p)
                if caption is None:
                    caption = pipe.run_caption(sr_pil)
                ready.append((p, sr_pil, caption))
            except Exception as e:  # one image's failure spares the others
                log.exception("failed on %s: %s", p, e)
                self.statuses[p] = f"error: {e}"
        self.timings["per_image"] = self._now() - t0

        t0 = self._now()
        groups: dict = {}
        for p, sr_pil, caption in ready:
            groups.setdefault(self._refine_group_key(sr_pil), []).append(
                (p, sr_pil, caption))

        def save_finals(p, final):
            finals = final if isinstance(final, list) else [final]
            for i, f in enumerate(finals):
                f.save(final_dir / f"{p.stem}_final_{i}.png")

        for key, members in groups.items():
            for i in range(0, len(members), self.refine_batch):
                chunk = members[i:i + self.refine_batch]
                t1 = self._now()
                try:
                    finals = pipe.run_refinement_batch(
                        [(s, c) for _, s, c in chunk])
                    for (p, _, _), final in zip(chunk, finals):
                        save_finals(p, final)
                        self.statuses[p] = "ok"
                except Exception as e:
                    self._fallback("refine", e)
                    for p, s, c in chunk:
                        try:
                            save_finals(p, pipe.run_refinement(s, c))
                            self.statuses[p] = "ok"
                        except Exception as e2:
                            log.exception("failed on %s: %s", p, e2)
                            self.statuses[p] = f"error: {e2}"
                dfb = pipe.last_dfb or {}
                self.refine_chunks.append(dict(
                    n=len(chunk), shape=list(key),
                    seconds=self._now() - t1,
                    sampling_s=pipe.timings.get("sampling"),
                    capture_s={k: v for k, v in pipe.capture_s.items()
                               if k.startswith("sampling_")},
                    hits=dfb.get("hits"), steps=dfb.get("steps"),
                    trace="".join("H" if h else "."
                                  for h in dfb.get("trace", []))))
        self.timings["refine"] = self._now() - t0
        self.timings["folder"] = self._now() - t_run
        return [(p.name, self.statuses.get(p, "error: unprocessed"))
                for p in images]

    def _refine_group_key(self, sr_pil):
        """The bucketed post-resize shape (JAX `_refine_group_key`): the
        min_size scale and the rounding to 64 of pil_to_array, worked out
        from the PIL size, then the size_bucket (else 64) multiple."""
        r = self.cfg.refine
        w, h = (float(v) for v in sr_pil.size)
        if min(w, h) < r.min_size:
            s = r.min_size / min(w, h)
            w *= s
            h *= s
        hh, ww = round_to_multiple(h, 64), round_to_multiple(w, 64)
        b = r.size_bucket or 64
        return (-(-hh // b) * b, -(-ww // b) * b)
