"""CLIP ViT vision towers (rsvldm_tpu/models/vlm/vision.py): CLIP-L/14-336
and the CLIP-architecture families build_vision_tower dispatches to
(open_clip, `hf:` configs, MLCD).

Parameter names are HF CLIPVisionModel's (`vision_model.embeddings.*`,
`vision_model.pre_layrnorm`, `vision_model.encoder.layers.{i}.*`), the names
convert_hf_clip_vision reads; MLCD's add `vision_model.class_pos_emb` and
drop the position table (`pos_embed="rope2d"`: 2D rotary angles on the
patch grid, rotate-half, a learned angle row for the class token, JAX
`_rope2d_angles`). open_clip checkpoints are mapped to these names by
towers.py. 14x14 patch conv, CLS token, pre-LN, non-causal blocks with
quick_gelu, exact gelu (MLCD) or tanh gelu, an FFN of `ffn_width` (4 x
width by default). Features follow `select_feature` (JAX `_slice_indices`):
one hidden state `select_layer` (HF indexing: hidden_states[0] is the
pre-LN output, [i + 1] block i's output; open_clip indexing,
`hidden_base="open_clip"`: [i] is block i's output), or the channel
concat of several (`slicefour_*`: every k-th of four, `slice_m25811_f6_*`:
-2, -5, -8, -11 and 6), the CLS token dropped ('patch') or kept at 0
(`cls_patch`, or keep_cls); the blocks after the last one read are not
run. Pixels come in [N, H, W, 3], the JAX layout. `CLIPVisionEmbedder` is
the HF CLIPModel image-feature head over the same tower (the quality
harness's scorer). `s2_multiscale_features` is the S2 wrapper.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
import torch.nn.functional as F

from ...ops.attention import attention
from ...ops.image import resize_linear
from ...ops.norm import LayerNorm32

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 336
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    select_layer: int = -2
    keep_cls: bool = False      # True: [N, 1 + T, W] with CLS at 0
    # "" (from keep_cls), "patch", "cls_patch", "slicefour_*",
    # "slice_m25811_f6_*" (JAX vision.py:38-42)
    select_feature: str = ""
    act: str = "quick_gelu"     # "gelu": MLCD, open_clip; "gelu_tanh"
    ffn_width: int = 0          # 0 -> width * 4 (MLCD bigG: 8192)
    pos_embed: str = "learned"  # "learned" | "rope2d" (MLCD)
    hidden_base: str = "hf"     # "hf" | "open_clip" hidden-state indexing

    def __post_init__(self):
        if self.act not in _ACTS:
            raise ValueError(f"CLIPVisionConfig.act {self.act!r}: one of "
                             f"{sorted(_ACTS)}")
        if self.pos_embed not in ("learned", "rope2d"):
            raise ValueError(f"CLIPVisionConfig.pos_embed {self.pos_embed!r}")
        if self.hidden_base not in ("hf", "open_clip"):
            raise ValueError(f"CLIPVisionConfig.hidden_base {self.hidden_base!r}")

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_per_side ** 2

    @property
    def feature_mode(self) -> str:
        if self.select_feature:
            return self.select_feature
        return "cls_patch" if self.keep_cls else "patch"


_ACTS = {"quick_gelu": lambda h: h * torch.sigmoid(1.702 * h),
         "gelu": F.gelu,
         "gelu_tanh": lambda h: F.gelu(h, approximate="tanh")}

CLIP_VIT_L_336_CONFIG = CLIPVisionConfig()


def normalize_pixels(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3] in [0, 1] -> CLIP-normalized."""
    mean = torch.tensor(CLIP_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def slice_indices(cfg: CLIPVisionConfig) -> list:
    """The hidden-state indices the features read (JAX `_slice_indices`)."""
    n_hidden = cfg.layers + (1 if cfg.hidden_base == "hf" else 0)
    mode = cfg.feature_mode
    if mode.startswith("slicefour_"):
        k = n_hidden // 4
        return list(range(k + cfg.select_layer, n_hidden, k))
    if mode.startswith("slice_m25811_f6_"):
        return [i % n_hidden for i in (-2, -5, -8, -11, 6)]
    return [cfg.select_layer % n_hidden]


def rope2d_angles(cfg: CLIPVisionConfig, class_row: torch.Tensor,
                  grid_h: int, grid_w: int):
    """MLCD's 2D rotary tables (JAX `_rope2d_angles`): the h and w position
    ids each rotate head_dim // 4 frequencies, the class token takes the
    learned row. (cos, sin) [1 + T, head_dim] fp32."""
    hd = cfg.width // cfg.heads
    dev = class_row.device
    inv_freq = 1.0 / (10000.0 ** (torch.arange(0, hd // 2, 2, dtype=torch.float32,
                                               device=dev) / (hd // 2)))
    seq = torch.arange(max(grid_h, grid_w), dtype=torch.float32, device=dev)
    full = seq[:, None] * inv_freq[None]
    hpos = torch.arange(grid_h, device=dev).repeat_interleave(grid_w)
    wpos = torch.arange(grid_w, device=dev).repeat(grid_h)
    rpe = torch.cat([full[hpos], full[wpos]], dim=-1)
    rpe = torch.cat([class_row.float(), rpe], dim=0)
    emb = torch.cat([rpe, rpe], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rope_apply(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate-half on [B, S, H, D] in fp32, cast back."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    return (xf * cos[None, :, None] + rot * sin[None, :, None]).to(x.dtype)


class _SelfAttention(nn.Module):
    def __init__(self, w: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(w, w)
        self.k_proj = nn.Linear(w, w)
        self.v_proj = nn.Linear(w, w)
        self.out_proj = nn.Linear(w, w)

    def forward(self, h, rope=None):
        b, s, w = h.shape
        split = lambda t: t.reshape(b, s, self.heads, w // self.heads)
        q, k = split(self.q_proj(h)), split(self.k_proj(h))
        if rope is not None:
            q, k = _rope_apply(q, *rope), _rope_apply(k, *rope)
        o = attention(q, k, split(self.v_proj(h)))
        return self.out_proj(o.reshape(b, s, w))


class _MLP(nn.Module):
    def __init__(self, w: int, ffn: int, act: str):
        super().__init__()
        self.act = _ACTS[act]
        self.fc1 = nn.Linear(w, ffn)
        self.fc2 = nn.Linear(ffn, w)

    def forward(self, h):
        return self.fc2(self.act(self.fc1(h)))


class ViTBlock(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layer_norm1 = LayerNorm32(cfg.width, eps=1e-5)
        self.self_attn = _SelfAttention(cfg.width, cfg.heads)
        self.layer_norm2 = LayerNorm32(cfg.width, eps=1e-5)
        self.mlp = _MLP(cfg.width, cfg.ffn_width or 4 * cfg.width, cfg.act)

    def forward(self, x, rope=None):
        dt = x.dtype
        x = x + self.self_attn(self.layer_norm1(x).to(dt), rope)
        return x + self.mlp(self.layer_norm2(x).to(dt))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(cfg.width))
        self.patch_embedding = nn.Conv2d(3, cfg.width, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        if cfg.pos_embed == "learned":
            self.position_embedding = nn.Embedding(cfg.num_patches + 1, cfg.width)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList(ViTBlock(cfg) for _ in range(cfg.layers))


class _VisionModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, post_layernorm: bool = False):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        if cfg.pos_embed == "rope2d":
            self.class_pos_emb = nn.Parameter(
                torch.zeros(1, (cfg.width // cfg.heads) // 2))
        self.pre_layrnorm = LayerNorm32(cfg.width, eps=1e-5)
        self.encoder = _Encoder(cfg)
        if post_layernorm:
            self.post_layernorm = LayerNorm32(cfg.width, eps=1e-5)

    def hidden_states(self, pixels: torch.Tensor, want: list) -> list:
        """pixels [N, S, S, 3] CLIP-normalized -> the hidden states at the
        indices `want` (cfg.hidden_base's indexing), CLS at 0, each
        [N, 1 + (S/patch)^2, width]; no block past the last one is run."""
        cfg, emb = self.cfg, self.embeddings
        dt = emb.patch_embedding.weight.dtype
        x = emb.patch_embedding(pixels.permute(0, 3, 1, 2).to(dt))
        gh, gw = x.shape[-2:]
        x = x.flatten(2).transpose(1, 2)  # [N, h*w, W], row-major patches
        cls = emb.class_embedding.to(dt).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
        rope = None
        if cfg.pos_embed == "rope2d":
            rope = rope2d_angles(cfg, self.class_pos_emb, gh, gw)
        else:
            x = x + emb.position_embedding.weight[None].to(dt)
        x = self.pre_layrnorm(x).to(dt)
        base = 1 if cfg.hidden_base == "hf" else 0
        hidden = {0: x} if base else {}
        for i, block in enumerate(self.encoder.layers[:max(want) + 1 - base]):
            x = block(x, rope)
            hidden[i + base] = x
        return [hidden[i] for i in want]

    def hidden(self, pixels: torch.Tensor, select_layer: int) -> torch.Tensor:
        """The HF hidden state `select_layer`, CLS at 0."""
        n_hidden = len(self.encoder.layers) + 1
        return self.hidden_states(pixels, [select_layer % n_hidden])[0]


class CLIPVisionTower(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig = CLIP_VIT_L_336_CONFIG):
        super().__init__()
        self.cfg = cfg
        self.vision_model = _VisionModel(cfg)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels [N, S, S, 3] CLIP-normalized -> [N, (S/14)^2, k * width]
        ('patch', k hidden states read), or with the CLS row at 0."""
        states = self.vision_model.hidden_states(pixels, slice_indices(self.cfg))
        x = torch.cat(states, dim=-1) if len(states) > 1 else states[0]
        return x if self.cfg.feature_mode.endswith("cls_patch") else x[:, 1:]


class CLIPVisionEmbedder(nn.Module):
    """HF CLIPModel.get_image_features: the tower through its last block,
    post_layernorm on the CLS row, then visual_projection, in fp32. Names
    are CLIPModel's (`vision_model.*`, `vision_model.post_layernorm`,
    `visual_projection.weight`)."""

    def __init__(self, cfg: CLIPVisionConfig, projection_dim: int = 768):
        super().__init__()
        self.cfg = dataclasses.replace(cfg, select_layer=-1, keep_cls=True)
        self.vision_model = _VisionModel(self.cfg, post_layernorm=True)
        self.visual_projection = nn.Linear(cfg.width, projection_dim, bias=False)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels [N, S, S, 3] CLIP-normalized -> [N, projection_dim] fp32."""
        vm = self.vision_model
        cls = vm.post_layernorm(vm.hidden(pixels, -1)[:, 0])
        return cls.float() @ self.visual_projection.weight.float().t()


def s2_multiscale_features(vision_apply, images: torch.Tensor,
                           scales=(336, 672), patch_size: int = 14):
    """The S2 wrapper (JAX `s2_multiscale_features`): per scale, resize the
    [N, H, W, 3] batch (JAX's linear resize, antialiased when it shrinks:
    ops/image.resize_linear), cut it into (scale / base)^2 tiles of the base
    size, run the tower on all tiles in one batch, put the tiles' token
    grids back together, average-pool to the base grid, and concatenate
    the scales along channels: [N, T_base, C * len(scales)]."""
    scales = sorted(scales)
    base, n, ch = scales[0], images.shape[0], images.shape[-1]
    t_side = base // patch_size
    outs = []
    for scale in scales:
        k = scale // base
        img = resize_linear(images, (scale, scale)).to(images.dtype)
        tiles = img.reshape(n, k, base, k, scale // k, ch)
        tiles = tiles.permute(0, 1, 3, 2, 4, 5).reshape(n * k * k, base, base, ch)
        feats = vision_apply(tiles)
        c = feats.shape[-1]
        grid = feats.reshape(n, k, k, t_side, t_side, c)
        grid = grid.permute(0, 1, 3, 2, 4, 5).reshape(n, k * t_side, k * t_side, c)
        if k > 1:
            grid = grid.reshape(n, t_side, k, t_side, k, c).mean(dim=(2, 4))
        outs.append(grid.reshape(n, t_side * t_side, c))
    return torch.cat(outs, dim=-1)
