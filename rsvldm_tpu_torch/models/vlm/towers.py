"""The vision-tower registry (rsvldm_tpu/models/vlm/towers.py): a reference
`mm_vision_tower` name -> (the port's module, a key map from the
reference's checkpoint names to the module's, the input size, S2).

  openai/laion/ShareGPT4V/<path>  CLIP ViT (geometry from a local
                                  config.json when the name is a directory)
  *siglip*                        SigLIP so400m-384
  hf:<local dir>                  a CLIP-architecture tower from the
                                  directory's config.json (no hub access)
  open_clip_hub:<model>           open_clip ViT: open_clip hidden-state
                                  indexing, and `convert` splits the fused
                                  in_proj into HF CLIP names
  mlcd-vit-bigG-patch14*          MLCD: the 2D-RoPE CLIP variant (-448: the
                                  same weights at 448 px)
  *eva02* / *eva01* / internal-eva EVA-CLIP (eva_vit.py; its names are the
                                  reference's, `convert` keeps them)
  imagebind_huge                  raises, as in JAX (an external package)

`build_vision_tower` builds the module on the card unless the caller names
a device (device.resolve_device), in the device's compute dtype, with
seeded weights (utils/weights.seeded_init_); load a checkpoint with
`utils/checkpoint.load_checked(spec.module, spec.convert(sd), ...)`.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Callable, Dict, NamedTuple

import torch

from ...device import compute_dtype, resolve_device
from .eva_vit import EVA_GEOMETRIES, EvaVisionTower
from .siglip import SIGLIP_SO400M_384_CONFIG, SigLIPVisionTower
from .vision import CLIP_VIT_L_336_CONFIG, CLIPVisionTower

# the port's copies of JAX towers.py's geometry tables
_OPEN_CLIP_GEOMETRY = {
    "ViT-H-14-378-quickgelu": dict(image_size=378, patch_size=14, width=1280,
                                   layers=32, heads=16, act="quick_gelu"),
    "ViT-H-14": dict(image_size=224, patch_size=14, width=1280,
                     layers=32, heads=16, act="gelu"),
    "ViT-bigG-14": dict(image_size=224, patch_size=14, width=1664,
                        layers=48, heads=16, act="gelu", ffn_width=8192),
}
_MLCD_BIGG = dict(image_size=336, patch_size=14, width=1664, layers=48,
                  heads=16, act="gelu", ffn_width=8192, pos_embed="rope2d")


class VisionTowerSpec(NamedTuple):
    module: Any                      # the tower, pixels [N, H, W, 3] in
    convert: Callable[[dict], dict]  # reference names -> the module's
    image_size: int
    s2: bool = False                 # wrap with s2_multiscale_features


def _identity(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return dict(sd)


def openclip_to_hf(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """open_clip VisionTransformer names (`visual.` stripped: conv1,
    class_embedding, positional_embedding, ln_pre,
    transformer.resblocks.{i}.{ln_1, attn.in_proj_*, attn.out_proj, ln_2,
    mlp.c_fc, mlp.c_proj}) -> the CLIP tower's HF names, the fused q/k/v
    split in three (JAX convert_openclip_vision's map)."""
    pre = "vision_model"
    out = {f"{pre}.embeddings.patch_embedding.weight": sd["conv1.weight"],
           f"{pre}.embeddings.class_embedding": sd["class_embedding"],
           f"{pre}.embeddings.position_embedding.weight": sd["positional_embedding"]}
    names = {"ln_pre": "pre_layrnorm"}
    blk = {"ln_1": "layer_norm1", "ln_2": "layer_norm2",
           "attn.out_proj": "self_attn.out_proj", "mlp.c_fc": "mlp.fc1",
           "mlp.c_proj": "mlp.fc2"}
    for k, v in sd.items():
        if k.startswith("ln_pre."):
            out[f"{pre}.{names['ln_pre']}.{k.split('.', 1)[1]}"] = v
        if not k.startswith("transformer.resblocks."):
            continue
        i, rest = k[len("transformer.resblocks."):].split(".", 1)
        lp = f"{pre}.encoder.layers.{i}"
        if rest.startswith("attn.in_proj_"):
            kind = rest[len("attn.in_proj_"):]
            for n, part in zip(("q_proj", "k_proj", "v_proj"), v.chunk(3, dim=0)):
                out[f"{lp}.self_attn.{n}.{kind}"] = part
            continue
        for a, b in blk.items():
            if rest.startswith(a + "."):
                out[f"{lp}.{b}.{rest[len(a) + 1:]}"] = v
    return out


def _load_hf_geometry(name: str) -> dict:
    """A CLIP-architecture geometry from the local `<name>/config.json`
    (its vision_config when nested)."""
    cfg_path = Path(name) / "config.json"
    if not cfg_path.is_file():
        raise FileNotFoundError(
            f"hf: vision towers need a local checkout with config.json; "
            f"missing {cfg_path} (the port reads no hub)")
    raw = json.loads(cfg_path.read_text())
    raw = raw.get("vision_config", raw)
    act = raw.get("hidden_act", "quick_gelu")
    acts = {"gelu": "gelu", "gelu_pytorch_tanh": "gelu_tanh",
            "quick_gelu": "quick_gelu"}
    if act not in acts:
        raise ValueError(f"unsupported vision hidden_act {act!r} in "
                         f"{cfg_path} (supported: {sorted(acts)})")
    return dict(image_size=raw.get("image_size", 336),
                patch_size=raw.get("patch_size", 14),
                width=raw.get("hidden_size", 1024),
                layers=raw.get("num_hidden_layers", 24),
                heads=raw.get("num_attention_heads", 16),
                act=acts[act],
                ffn_width=raw.get("intermediate_size", 0) or 0)


def tower_config(vision_tower: str, select_layer: int = -2,
                 select_feature: str = "patch"):
    """(module class, its config or (config, keep_cls), key map) of a
    reference tower name: build_vision_tower's dispatch without building."""
    name = vision_tower

    def clip(geom: dict, convert=_identity, hidden_base: str = "hf"):
        cfg = dataclasses.replace(
            CLIP_VIT_L_336_CONFIG, select_layer=select_layer,
            select_feature=select_feature, hidden_base=hidden_base, **geom)
        return CLIPVisionTower, (cfg,), convert, cfg.image_size

    if (Path(name).exists() or name.startswith("openai")
            or name.startswith("laion") or "ShareGPT4V" in name):
        geom = (_load_hf_geometry(name)
                if (Path(name) / "config.json").is_file() else {})
        return clip(geom)
    if "siglip" in name:
        cfg = dataclasses.replace(SIGLIP_SO400M_384_CONFIG,
                                  select_layer=select_layer)
        return SigLIPVisionTower, (cfg,), _identity, cfg.image_size
    if name.startswith("hf:"):
        return clip(_load_hf_geometry(name[3:]))
    if name == "imagebind_huge":
        raise NotImplementedError(
            "imagebind_huge depends on the external `imagebind` package even "
            "in the reference; it is not ported (as in the JAX package)")
    low = name.lower()
    if "internal-eva" in low or "eva02" in low or "eva01" in low:
        cand = low.replace("internal-", "")
        # the longest key wins (eva02-clip-l-14 is a prefix of ...-336)
        key = max((k for k in EVA_GEOMETRIES if k in cand), key=len, default=None)
        if key is None:
            raise ValueError(f"Unknown EVA tower: {name} "
                             f"(known: {sorted(EVA_GEOMETRIES)})")
        cfg = EVA_GEOMETRIES[key]
        return (EvaVisionTower, (cfg, select_feature == "cls_patch"), _identity,
                cfg.image_size)
    if name.startswith("open_clip_hub"):
        model = name.replace("open_clip_hub:", "")
        if model not in _OPEN_CLIP_GEOMETRY:
            raise ValueError(f"Unknown open_clip tower: {model} "
                             f"(known: {sorted(_OPEN_CLIP_GEOMETRY)})")
        return clip(_OPEN_CLIP_GEOMETRY[model], openclip_to_hf, "open_clip")
    if "mlcd-vit-bigG-patch14" in name:
        geom = dict(_MLCD_BIGG)
        if "448" in name.split("patch14", 1)[1]:
            geom["image_size"] = 448  # the same weights; RoPE has no size
        return clip(geom)
    raise ValueError(f"Unknown vision tower: {vision_tower}")


@torch.no_grad()
def build_vision_tower(vision_tower: str, select_layer: int = -2,
                       select_feature: str = "patch", s2: bool = False,
                       device: str | torch.device | None = None
                       ) -> VisionTowerSpec:
    """The tower of a reference name (JAX build_vision_tower), built on
    `device` (the card unless the CPU is asked for) in the device's compute
    dtype with seeded weights. Unknown names raise ValueError,
    imagebind_huge NotImplementedError."""
    from ...utils.weights import seeded_init_
    device = resolve_device(device)
    cls, args, convert, size = tower_config(vision_tower, select_layer,
                                            select_feature)
    with torch.device("meta"):
        module = cls(*args)
    module = module.to(dtype=compute_dtype(device)).to_empty(device=device)
    seeded_init_(module, f"vision_tower:{vision_tower}", device)
    return VisionTowerSpec(module.eval().requires_grad_(False), convert, size,
                           s2=s2)
