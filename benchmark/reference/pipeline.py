"""The reference pipeline: `SuperResolutionPipeline.process` of the
configuration, in plain torch and fp32 (TF32 off), built from the same
bf16 state dicts the port is given.

  Stage 1  - the SR3 ancestral loop on the bicubic-upsampled LR tile
  Stage 2a - the caption's logits (caption.py)
  Stage 2b - the twin VAE encoder, decode and re-encode, the CLIP-L and
             bigG conditioning of hash-bucket tokens, RestoreEDM with the
             first-block cache (its own hit decisions), the VAE decode and
             the wavelet colour fix

Noise is JAX's key chain from the pipeline seed (`KeyChain`, the port's
`KeyChainNoise` on the plain draws): each earlier `process()` call split
the key once for Stage 1 and once, in four, for the refinement.

`lower_precision(module)` makes the control: every Linear and Conv2d of
the module takes fp8 (e4m3) weights, scaled per output channel, and fp8
inputs, scaled per tensor, the step below the configuration's bf16."""

from __future__ import annotations

import zlib

import numpy as np
import torch
from torch import nn

from . import colorfix, prng
from .clip_text import CLIPTextConfig, CLIPTextTransformer
from .conditioner import SDXLConditioner
from .denoiser import ControlDenoiser
from .edm import RestoreEDMConfig, restore_edm_sample
from .image import array_to_pil, load_lr_conditioning, pil_to_array, to_uint8
from .projector import MLPProjector
from .quant import fp8
from .sdxl_control import ControlledUNet, GLVControl
from .sdxl_unet import SDXLUNetConfig
from .sr3 import SR3Diffusion, sr3_sample
from .sr3_unet import SR3UNet, SR3UNetConfig
from .vae import AutoencoderKL, VAEConfig
from .vision import CLIPVisionConfig, CLIPVisionTower

def tuple_fields(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def family_configs(spec: dict) -> dict:
    """{family: (module class, its config)} of the diffusion side."""
    sdxl = SDXLUNetConfig(**tuple_fields(spec["sdxl"]))
    return {"sr3": (SR3UNet, SR3UNetConfig(**tuple_fields(spec["sr3"]))),
            "unet": (ControlledUNet, sdxl), "control": (GLVControl, sdxl),
            "vae": (AutoencoderKL, VAEConfig(**tuple_fields(spec["vae"]))),
            "clip_l": (CLIPTextTransformer,
                       CLIPTextConfig(**tuple_fields(spec["clip_l"]))),
            "big_g": (CLIPTextTransformer,
                      CLIPTextConfig(**tuple_fields(spec["big_g"])))}


def vision_config(spec: dict) -> CLIPVisionConfig:
    return CLIPVisionConfig(**tuple_fields(spec["vision"]))


def build(cls, cfg, sd: dict, device) -> nn.Module:
    """cls(cfg) in fp32 on `device`, filled from `sd` (every name)."""
    with torch.device("meta"):
        module = cls(cfg) if cfg is not None else cls()
    module = module.to_empty(device=device).float()
    module.load_state_dict(sd, strict=True)
    return module.eval().requires_grad_(False)


def lower_precision(module: nn.Module) -> nn.Module:
    """The control: fp8 weights and inputs in every Linear and Conv2d."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            w = m.weight.data
            m.weight.data = fp8(w, dim=tuple(range(1, w.dim())))
            m.register_forward_pre_hook(lambda _m, args: (fp8(args[0]),
                                                          *args[1:]))
    return module


class KeyChain:
    """The pipeline's draws from PRNGKey(seed): `skip(n)` passes n earlier
    process() calls."""

    def __init__(self, seed: int, device):
        self.device = device
        self.key = prng.key(seed)
        self.k_noise = self.k_loop = None

    def skip_stage1(self):
        """Pass a Stage-1 draw (its key split)."""
        self.key = prng.split(self.key)[0]

    def skip(self, calls: int):
        for _ in range(calls):
            self.key = prng.split(self.key)[0]
            self.key = prng.split(self.key, 4)[0]

    def __call__(self, name: str, shape: tuple, steps=None) -> torch.Tensor:
        if name == "stage1":
            self.key, sub = prng.split(self.key)
            rng, init = prng.split(sub)
            rows = [(init, None)] + [(rng, int(t)) for t in steps]
            return prng.draw(rows, shape[1:], "normal", torch.float32, self.device)
        if name == "vae_sample":
            self.key, k_enc, self.k_noise, self.k_loop = prng.split(self.key, 4)
            rows = [(k_enc, None)]
        elif name == "edm_init":
            rows = [(self.k_noise, None)]
        else:  # churn
            rows = [(self.k_loop, i) for i in range(shape[0])]
            return prng.draw(rows, shape[1:], "normal", torch.float32, self.device)
        return prng.draw(rows, shape, "normal", torch.float32, self.device)[0]


def hash_tokens(texts, vocab: int) -> np.ndarray:
    """CLIP tokens [N, 77] without a BPE vocabulary: BOS 1, crc32 buckets
    of up to 75 lower-cased words, EOT vocab-1, zero padding."""
    out = np.zeros((len(texts), 77), np.int64)
    for i, t in enumerate(texts):
        words = t.lower().split()[:75]
        out[i, 0] = 1
        for j, w in enumerate(words):
            out[i, j + 1] = (zlib.crc32(w.encode()) % (vocab - 3)) + 2
        out[i, len(words) + 1] = vocab - 1
    return out


def sampler_config(r: dict) -> RestoreEDMConfig:
    return RestoreEDMConfig(
        num_steps=r["edm_steps"], cfg_scale=r["s_cfg"],
        cfg_scale_start=r["spt_linear_cfg"], use_linear_cfg=r["linear_cfg"],
        restore_cfg=r["s_stage1"], s_churn=r["s_churn"], s_noise=r["s_noise"],
        control_scale=r["s_stage2"],
        use_linear_control_scale=r["linear_s_stage2"],
        control_scale_start=r["spt_linear_s_stage2"],
        img_threshold=r["img_threshold"], dec_img=1.0)


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


@torch.no_grad()
def stage1(spec: dict, sr3: nn.Module, lr_path: str, noise: KeyChain) -> np.ndarray:
    """The LR tile -> the uint8 HWC Stage-1 image."""
    s1 = spec["stage1"]
    cond = torch.from_numpy(load_lr_conditioning(lr_path, spec["upscale"]))[None]
    diff = SR3Diffusion.from_schedule(s1["schedule"], s1["steps"],
                                      s1["linear_start"], s1["linear_end"])
    t = diff.buffers.num_timesteps
    eps = noise("stage1", (t + 1, *cond.shape), steps=range(t - 1, -1, -1))
    x = sr3_sample(diff, sr3, cond.to(noise.device), eps)
    return to_uint8(x[0].cpu().numpy())


@torch.no_grad()
def refine(spec: dict, m: dict, sr_image, caption: str, noise: KeyChain):
    """Stage 2b on the saved Stage-1 image (PIL) and the caption:
    (the final PIL image, the cache-hit trace). `m` holds the modules
    unet, control, vae, clip_l, big_g."""
    r = spec["refine"]
    dev = noise.device
    x, h0, w0 = pil_to_array(sr_image, upscale=1, min_size=r["min_size"])
    x = _nchw(torch.from_numpy(np.ascontiguousarray(x))[None].to(dev))
    vae = m["vae"]
    z_lq = vae.encode_with_denoise(x)
    x_stage1 = vae.decode(z_lq)
    eps = noise("vae_sample", tuple(_nhwc(z_lq).shape))
    z_stage1 = vae.encode(x_stage1, noise=_nchw(eps))
    vocab = spec["clip_l"]["vocab_size"]
    to = lambda a: torch.from_numpy(a).to(dev)
    tc = to(hash_tokens([" ".join([caption, r["a_prompt"]])], vocab))
    tu = to(hash_tokens([r["n_prompt"]], vocab))
    cond, uc = SDXLConditioner(m["clip_l"], m["big_g"]).paired(
        tc, tc, tu, tu, _nhwc(z_lq))
    scfg = sampler_config(r)
    shape = tuple(cond["control"].shape)
    init = noise("edm_init", shape)
    churn = noise("churn", (scfg.num_steps, *shape)) if scfg.s_churn > 0 else None
    z, aux = restore_edm_sample(ControlDenoiser(unet=m["unet"],
                                                control_net=m["control"]),
                                cond, uc, init, _nhwc(z_stage1), scfg,
                                churn_noise=churn, return_aux=True)
    samples = _nhwc(vae.decode(_nchw(z)))
    fixed = colorfix.wavelet_reconstruction(samples, _nhwc(x_stage1))
    return array_to_pil(fixed[0].cpu().numpy(), h0, w0), aux["hit_trace"]


def build_captioner_parts(spec: dict, sd: dict, device):
    """(tower, projector, image newline) of a LLaVA state dict, fp32."""
    vis = "model.vision_tower.vision_tower."
    pre = "model.mm_projector."
    tower = build(CLIPVisionTower, vision_config(spec),
                  {k[len(vis):]: v for k, v in sd.items() if k.startswith(vis)},
                  device)
    dim = spec["text_config"]["hidden_size"]
    with torch.device("meta"):
        proj = MLPProjector(tower.cfg.width, dim, spec["projector_depth"])
    proj = proj.to_empty(device=device).float()
    proj.load_state_dict({k[len(pre):]: v for k, v in sd.items()
                          if k.startswith(pre)}, strict=True)
    newline = sd["model.image_newline"].to(device, torch.float32)
    return tower.eval(), proj.eval(), newline
