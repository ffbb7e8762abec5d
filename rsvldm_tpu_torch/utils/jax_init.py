"""The JAX package's seeded weights, drawn without JAX.

Where no checkpoint is found the JAX package draws its weights from a seed,
and so does the port, from the same keys (utils/prng.py), so that the same
command starts from the same weights:

- `jax_leaves(family, cfg)` is the Flax parameter tree of a family as
  `Module.init` builds it (rsvldm_tpu/models/...): each leaf's path, shape
  and dtype, in the order jax.tree_util.tree_flatten_with_path gives them
  (dict keys sorted as strings at every level, so "layer_10" comes before
  "layer_2"), whether or not the port keeps the leaf.
- `flax_key(key, scope, counter)` is the key Flax hands a parameter's
  initialiser (flax/core/scope.py: LazyRng, _fold_in_static, make_rng): one
  fold_in of the first four big-endian bytes of the SHA-1 over the names
  of the parameter's module scope and its make_rng count in that scope (1
  for the first `self.param` of a module, zeros and ones included), with
  flax_fix_rng_separator at its default, off.
- `smoke_init(family, cfg, device)` is the JAX pipeline's bf16 rule for a
  missing checkpoint (rsvldm_tpu/pipeline.py:173-205): leaf i of the
  flattened tree from fold_in(PRNGKey(crc32(family) % 2^31), i); biases
  and 0-d leaves 0, `scale` leaves 1, `kernel` leaves bf16 normals times
  (1 / fan_in)^0.5, the rest bf16 normals times 0.02. The leaves of one
  shape and scale are one `prng.draw` (on the card one launch of the
  threefry kernel).
- `flax_init(family, cfg, key, device)` is Flax's `Module.init(key, ...)`:
  Dense and Conv kernels lecun_normal (a truncated normal on (-2, 2) times
  sqrt(1 / fan_in) / 0.87962566103423978), biases and norm biases zeros,
  norm scales ones, RMSNorm weights ones (zeros for (1 + w) norms), nn.Embed
  variance_scaling(1, fan_in, normal, out_axis=0), and the JAX modules' own
  initialisers: the SDXL zero convs and the zero proj_out
  (models/sdxl/unet.py:82-83, 183), CLIP's token and position tables
  normal 0.02 / 0.01 and its text projection normal 0.02
  (models/text/clip.py:99-115). The leaves of one shape and initialiser
  are one `prng.draw`.

Both return the port's state dict (`params_from_jax` over the drawn tree)
on `device` in JAX's storage dtype (bf16 for the smoke rule, fp32 for
Flax's init). Families: sr3, unet (ControlledUNet), control (GLVControl),
vae, clip_l and big_g (CLIPTextTransformer), llama (a dense LlamaModel)
and projector (MLPProjector; its cfg is (in_dim, out_dim) or (in_dim,
out_dim, depth)).
"""

from __future__ import annotations

import hashlib
import math
import zlib
from dataclasses import dataclass
from typing import Dict, List

import torch

from ..models.sdxl.control import derive_project_specs
from ..models.sdxl.unet import _build_specs
from . import prng
from .weights import params_from_jax

FAMILIES = ("sr3", "unet", "control", "vae", "clip_l", "big_g", "llama",
            "projector")
LECUN, ZEROS, ONES, EMBED = ("lecun",), ("zeros",), ("ones",), ("embed",)
# the stddev of a standard normal truncated to (-2, 2) (jax.nn.initializers)
TRUNC_STD = 0.87962566103423978


@dataclass(frozen=True)
class Leaf:
    """One parameter of a Flax tree: its path (module scope names, then the
    parameter's name), shape, dtype, initialiser (LECUN, ZEROS, ONES, EMBED
    or ("normal", stddev)) and its make_rng count in its scope."""
    path: tuple
    shape: tuple
    dtype: torch.dtype
    init: tuple
    counter: int


class _Tree:
    """The parameters of a Flax module tree, recorded as Module.init creates
    them: each scope counts its own `self.param` calls."""

    def __init__(self):
        self.leaves: List[Leaf] = []
        self._count: Dict[tuple, int] = {}

    def param(self, scope: tuple, name: str, shape, init=LECUN):
        n = self._count[scope] = self._count.get(scope, 0) + 1
        self.leaves.append(Leaf(scope + (name,), tuple(int(s) for s in shape),
                                torch.float32, init, n))

    def dense(self, scope, din, dout, bias=True, kernel=LECUN):
        self.param(scope, "kernel", (din, dout), kernel)
        if bias:
            self.param(scope, "bias", (dout,), ZEROS)

    def conv(self, scope, k, cin, cout, bias=True, kernel=LECUN):
        self.param(scope, "kernel", (k, k, cin, cout), kernel)
        if bias:
            self.param(scope, "bias", (cout,), ZEROS)

    def zero_conv(self, scope, k, cin, cout):
        self.conv(scope, k, cin, cout, kernel=ZEROS)

    def norm(self, scope, c):
        """nn.GroupNorm / nn.LayerNorm / GroupNorm32: scale, then bias."""
        self.param(scope, "scale", (c,), ONES)
        self.param(scope, "bias", (c,), ZEROS)


# ------------------------------------------------------------------ SR3
def _sr3(t: _Tree, cfg):
    """rsvldm_tpu/models/sr3/unet.py::SR3UNet."""
    ic = cfg.inner_channel
    t.dense(("noise_level_mlp", "fc1"), ic, ic * 4)
    t.dense(("noise_level_mlp", "fc2"), ic * 4, ic)

    def conv_block(s, cin, cout):
        t.norm(s + ("norm",), cin)
        t.conv(s + ("conv",), 3, cin, cout)

    def res_with_attn(name, cin, cout, attn):
        rb = (name, "res_block")
        conv_block(rb + ("block1",), cin, cout)
        t.dense(rb + ("noise_func",), ic, cout)
        conv_block(rb + ("block2",), cout, cout)
        if cin != cout:
            t.conv(rb + ("res_conv",), 1, cin, cout)
        if attn:
            t.norm((name, "attn", "norm"), cout)
            t.conv((name, "attn", "qkv"), 1, cout, 3 * cout, bias=False)
            t.conv((name, "attn", "out"), 1, cout, cout)

    n = len(cfg.channel_mults)
    res, cur = cfg.image_size, ic
    t.conv(("conv_in",), 3, cfg.in_channel, ic)
    feats = [ic]
    for ind in range(n):
        ch = ic * cfg.channel_mults[ind]
        for blk in range(cfg.res_blocks):
            res_with_attn(f"down_{ind}_{blk}", cur, ch, res in cfg.attn_res)
            cur = ch
            feats.append(cur)
        if ind != n - 1:
            t.conv((f"downsample_{ind}",), 3, cur, cur)
            feats.append(cur)
            res //= 2
    res_with_attn("mid_0", cur, cur, True)
    res_with_attn("mid_1", cur, cur, False)
    for ind in reversed(range(n)):
        ch = ic * cfg.channel_mults[ind]
        for blk in range(cfg.res_blocks + 1):
            res_with_attn(f"up_{ind}_{blk}", cur + feats.pop(), ch,
                          res in cfg.attn_res)
            cur = ch
        if ind > 0:
            t.conv((f"upsample_{ind}",), 3, cur, cur)
            res *= 2
    conv_block(("final_conv",), cur, cfg.out_channel)


# ----------------------------------------------------------- SDXL UNet
def _res(t, s, cin, cout, temb):
    """models/sdxl/unet.py::ResBlock (out_conv zero-initialised)."""
    t.norm(s + ("in_norm",), cin)
    t.conv(s + ("in_conv",), 3, cin, cout)
    t.dense(s + ("emb_proj",), temb, cout)
    t.norm(s + ("out_norm",), cout)
    t.zero_conv(s + ("out_conv",), 3, cout, cout)
    if cin != cout:
        t.conv(s + ("skip",), 1, cin, cout)


def _xattn(t, s, qdim, cdim, inner):
    for n, d in (("to_q", qdim), ("to_k", cdim), ("to_v", cdim)):
        t.dense(s + (n,), d, inner, bias=False)
    t.dense(s + ("to_out",), inner, qdim)


def _st(t, s, c, depth, cfg):
    """SpatialTransformer (proj_out zero-initialised)."""
    inner = c // cfg.num_head_channels * cfg.num_head_channels
    t.norm(s + ("norm",), c)
    t.dense(s + ("proj_in",), c, c)
    for d in range(depth):
        b = s + (f"block_{d}",)
        _xattn(t, b + ("attn1",), c, c, inner)
        _xattn(t, b + ("attn2",), c, cfg.context_dim, inner)
        t.dense(b + ("ff", "proj"), c, c * 8)
        t.dense(b + ("ff", "out"), c * 4, c)
        for n in ("norm1", "norm2", "norm3"):
            t.norm(b + (n,), c)
    t.dense(s + ("proj_out",), c, c, kernel=ZEROS)


def _encoder_half(t, p, cfg) -> int:
    """UNetModel / GLVControl's shared half: the embeddings, conv_in, the
    input cells and the middle; returns the stream's channels."""
    ted, mc = cfg.model_channels * 4, cfg.model_channels
    t.dense(p + ("time_dense1",), mc, ted)
    t.dense(p + ("time_dense2",), ted, ted)
    t.dense(p + ("label_dense1",), cfg.adm_in_channels, ted)
    t.dense(p + ("label_dense2",), ted, ted)
    t.conv(p + ("conv_in",), 3, cfg.in_channels, mc)
    cur = mc
    for i, s in enumerate(_build_specs(cfg)[0]):
        cell = p + (f"input_{i}",)
        if s["kind"] == "down":
            t.conv(cell + ("down_conv",), 3, cur, cur)
            continue
        _res(t, cell + ("resblock",), cur, s["out_ch"], ted)
        cur = s["out_ch"]
        if s["st_depth"] > 0:
            _st(t, cell + ("transformer",), cur, s["st_depth"], cfg)
    mid = mc * cfg.channel_mult[-1]
    _res(t, p + ("mid_res1",), cur, mid, ted)
    _st(t, p + ("mid_transformer",), mid, cfg.transformer_depth[-1], cfg)
    _res(t, p + ("mid_res2",), mid, mid, ted)
    return mid


def _unet(t: _Tree, cfg):
    """models/sdxl/control.py::ControlledUNet: "unet" and project_i."""
    p, ted = ("unet",), cfg.model_channels * 4
    cur = _encoder_half(t, p, cfg)
    _, out_specs, skip_ch = _build_specs(cfg)
    skips = list(skip_ch)
    for i, s in enumerate(out_specs):
        cell = p + (f"output_{i}",)
        _res(t, cell + ("resblock",), cur + skips.pop(), s["out_ch"], ted)
        cur = s["out_ch"]
        if s["st_depth"] > 0:
            _st(t, cell + ("transformer",), cur, s["st_depth"], cfg)
        if s["has_up"]:
            t.conv(cell + ("up_conv",), 3, cur, cur)
    t.norm(p + ("out_norm",), cur)
    t.zero_conv(p + ("out_conv",), 3, cur, cfg.out_channels)
    specs = derive_project_specs(cfg)
    for c, s in enumerate(specs):
        m = (f"project_{len(specs) - 1 - c}",)
        if s["kind"] == "sft":
            total = s["norm_nc"] + s["concat_nc"]
            t.zero_conv(m + ("zero_conv",), 1, s["label_nc"], s["norm_nc"])
            t.conv(m + ("mlp_shared",), 3, s["label_nc"], 128)
            t.zero_conv(m + ("zero_mul",), 3, 128, total)
            t.zero_conv(m + ("zero_add",), 3, 128, total)
            t.norm(m + ("param_free_norm",), total)
        else:
            q, inner = s["query_dim"], s["query_dim"] // 64 * 64
            t.norm(m + ("norm1",), q)
            t.norm(m + ("norm2",), s["context_dim"])
            _xattn(t, m + ("attn",), q, s["context_dim"], inner)


def _control(t: _Tree, cfg):
    """models/sdxl/control.py::GLVControl (input_hint zero-initialised)."""
    _encoder_half(t, (), cfg)
    t.zero_conv(("input_hint",), 3, cfg.in_channels, cfg.model_channels)


# ------------------------------------------------------------------ VAE
def _vae(t: _Tree, cfg):
    """models/vae/model.py::AutoencoderKL: two encoders, the decoder and
    the quant convs."""
    def resblock(s, cin, cout):
        t.norm(s + ("norm1",), cin)
        t.conv(s + ("conv1",), 3, cin, cout)
        t.norm(s + ("norm2",), cout)
        t.conv(s + ("conv2",), 3, cout, cout)
        if cin != cout:
            t.conv(s + ("nin_shortcut",), 1, cin, cout)

    def mid(p, c):
        resblock(p + ("mid_block_1",), c, c)
        t.norm(p + ("mid_attn_1", "norm"), c)
        for n in ("q", "k", "v", "proj_out"):
            t.conv(p + ("mid_attn_1", n), 1, c, c)
        resblock(p + ("mid_block_2",), c, c)

    zf = 2 if cfg.double_z else 1
    for enc in ("encoder", "denoise_encoder"):
        p, cur = (enc,), cfg.ch
        t.conv(p + ("conv_in",), 3, cfg.in_channels, cur)
        for i, mult in enumerate(cfg.ch_mult):
            for j in range(cfg.num_res_blocks):
                resblock(p + (f"down_{i}_block_{j}",), cur, cfg.ch * mult)
                cur = cfg.ch * mult
            if i != len(cfg.ch_mult) - 1:
                t.conv(p + (f"down_{i}_downsample", "conv"), 3, cur, cur)
        mid(p, cur)
        t.norm(p + ("norm_out",), cur)
        t.conv(p + ("conv_out",), 3, cur, cfg.z_channels * zf)
    p, cur = ("decoder",), cfg.ch * cfg.ch_mult[-1]
    t.conv(p + ("conv_in",), 3, cfg.z_channels, cur)
    mid(p, cur)
    for i in reversed(range(len(cfg.ch_mult))):
        for j in range(cfg.num_res_blocks + 1):
            resblock(p + (f"up_{i}_block_{j}",), cur, cfg.ch * cfg.ch_mult[i])
            cur = cfg.ch * cfg.ch_mult[i]
        if i != 0:
            t.conv(p + (f"up_{i}_upsample", "conv"), 3, cur, cur)
    t.norm(p + ("norm_out",), cur)
    t.conv(p + ("conv_out",), 3, cur, cfg.out_ch)
    t.conv(("quant_conv",), 1, cfg.z_channels * zf, zf * cfg.embed_dim)
    t.conv(("post_quant_conv",), 1, cfg.embed_dim, cfg.z_channels)


# ------------------------------------------------------------------ CLIP
def _clip(t: _Tree, cfg):
    """models/text/clip.py::CLIPTextTransformer (CLIP-L and bigG)."""
    w = cfg.width
    t.param((), "token_embedding", (cfg.vocab_size, w), ("normal", 0.02))
    t.param((), "positional_embedding", (cfg.context_length, w),
            ("normal", 0.01))
    for i in range(cfg.layers):
        b = (f"block_{i}",)
        t.norm(b + ("ln_1",), w)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            t.dense(b + ("attn", n), w, w)
        t.norm(b + ("ln_2",), w)
        t.dense(b + ("mlp_fc",), w, 4 * w)
        t.dense(b + ("mlp_proj",), 4 * w, w)
    t.norm(("ln_final",), w)
    if cfg.use_text_projection:
        t.param((), "text_projection", (w, cfg.projection_dim or w),
                ("normal", 0.02))


# ------------------------------------------------------------ decoders
def _llama(t: _Tree, cfg):
    """models/vlm/llama.py::LlamaModel, dense (the smoke decoder's tree
    before quantization)."""
    if cfg.num_experts:
        raise NotImplementedError("jax_init: MoE decoders are not seeded by "
                                  "the JAX package")
    d, hd = cfg.dim, cfg.head_dim
    norm = ZEROS if cfg.norm_plus_one else ONES
    t.param(("embed_tokens",), "embedding", (cfg.vocab_size, d), EMBED)
    for i in range(cfg.layers):
        b = (f"layer_{i}",)
        t.param(b + ("attn_norm",), "weight", (d,), norm)
        for n, out in (("q_proj", cfg.heads * hd),
                       ("k_proj", cfg.kv_heads * hd),
                       ("v_proj", cfg.kv_heads * hd)):
            t.dense(b + (n,), d, out, bias=cfg.attn_bias)
        t.dense(b + ("o_proj",), cfg.heads * hd, d, bias=False)
        t.param(b + ("mlp_norm",), "weight", (d,), norm)
        t.dense(b + ("gate_proj",), d, cfg.ffn_dim, bias=False)
        t.dense(b + ("up_proj",), d, cfg.ffn_dim, bias=False)
        t.dense(b + ("down_proj",), cfg.ffn_dim, d, bias=False)
    t.param(("norm",), "weight", (d,), norm)
    if not cfg.tie_lm_head:
        t.dense(("lm_head",), d, cfg.vocab_size, bias=False)


def _projector(t: _Tree, cfg):
    """models/vlm/projector.py::MLPProjector: fc0 in -> out, fc_i out ->
    out."""
    din, dout, depth = (tuple(cfg) + (2,))[:3]
    for i in range(depth):
        t.dense((f"fc{i}",), din if i == 0 else dout, dout)


_TREES = {"sr3": _sr3, "unet": _unet, "control": _control, "vae": _vae,
          "clip_l": _clip, "big_g": _clip, "llama": _llama,
          "projector": _projector}


def tree_leaves(family: str, cfg) -> List[Leaf]:
    """The family's Flax parameters (`Leaf`s) in tree_flatten order."""
    if family not in _TREES:
        raise ValueError(f"jax_init: unknown family {family!r}, expected one "
                         f"of {FAMILIES}")
    t = _Tree()
    _TREES[family](t, cfg)
    return sorted(t.leaves, key=lambda leaf: leaf.path)


def jax_leaves(family: str, cfg) -> list:
    """[(path, shape, dtype)] of the family's Flax parameter tree (under
    "params"), in the order jax.tree_util.tree_flatten_with_path gives."""
    return [(leaf.path, leaf.shape, leaf.dtype)
            for leaf in tree_leaves(family, cfg)]


def flax_key(key: prng.Key, scope, counter: int) -> prng.Key:
    """The key Flax's make_rng("params") gives the `counter`-th parameter
    created in module scope `scope` (its names from the root) under the
    init key `key`."""
    m = hashlib.sha1()
    for x in (*scope, int(counter)):
        m.update(x.encode("utf-8") if isinstance(x, str)
                 else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return prng.fold_in(key, int.from_bytes(m.digest()[:4], "big"))


def _fan_in(shape, out_axis: int = -1) -> float:
    """jax.nn.initializers._compute_fans' fan_in (in_axis -2), in its float
    arithmetic."""
    in_size, out_size = shape[-2], shape[out_axis]
    return in_size * (math.prod(shape) / in_size / out_size)


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _stddev(init: tuple, shape) -> torch.Tensor:
    """The fp32 factor of a normal initialiser, as JAX computes it."""
    if init == LECUN:
        return torch.sqrt(_f32(1.0 / _fan_in(shape))) / _f32(TRUNC_STD)
    if init == EMBED:  # variance_scaling(1, fan_in, normal, out_axis=0)
        return torch.sqrt(_f32(1.0 / _fan_in(shape, out_axis=0)))
    return _f32(init[1])  # ("normal", stddev)


def _assemble(family: str, cfg, leaves, values) -> Dict[str, torch.Tensor]:
    tree: dict = {}
    for leaf, v in zip(leaves, values):
        node = tree
        for k in leaf.path[:-1]:
            node = node.setdefault(k, {})
        node[leaf.path[-1]] = v
    sd = params_from_jax(family, tree, cfg)
    return {k: v for k, v in sd.items() if v.device.type != "meta"}


def _seed_key(family: str) -> prng.Key:
    return prng.key(zlib.crc32(family.encode()) % (2 ** 31))


def smoke_groups(family: str, cfg) -> dict:
    """smoke_init's draws: {(shape, scale): [(leaf index, (key, index))]},
    one `prng.draw` each; the other leaves are zeros and ones."""
    key = _seed_key(family)
    groups: dict = {}
    for i, leaf in enumerate(tree_leaves(family, cfg)):
        name = leaf.path[-1]
        if name in ("bias", "scale") or not leaf.shape:
            continue
        # JAX multiplies by the Python float, rounded to bf16
        scale = ((1.0 / math.prod(leaf.shape[:-1])) ** 0.5
                 if name == "kernel" and len(leaf.shape) >= 2 else 0.02)
        groups.setdefault((leaf.shape, scale), []).append((i, (key, i)))
    return groups


def flax_groups(family: str, cfg, key: prng.Key | None = None) -> dict:
    """flax_init's draws: {(dist, shape, factor): [(leaf index, (Flax's
    key, None))]}, one `prng.draw` each; the other leaves are zeros and
    ones."""
    key = _seed_key(family) if key is None else key
    groups: dict = {}
    for i, leaf in enumerate(tree_leaves(family, cfg)):
        if leaf.init in (ZEROS, ONES):
            continue
        dist = "truncated_normal" if leaf.init == LECUN else "normal"
        factor = float(_stddev(leaf.init, leaf.shape))
        row = (flax_key(key, leaf.path[:-1], leaf.counter), None)
        groups.setdefault((dist, leaf.shape, factor), []).append((i, row))
    return groups


def _init(family, cfg, groups, ones, dtype, device,
          only) -> Dict[str, torch.Tensor]:
    """The state dict of `family` from its draw groups ({(dist, shape,
    factor): [(leaf index, row)]}); the leaves in no group are zeros, or
    ones where `ones(leaf)`. With `only` (a group key), that group's
    tensors alone."""
    leaves = tree_leaves(family, cfg)
    device = torch.device(device)
    values: list = [None] * len(leaves)
    for gkey, members in groups.items():
        if only is not None and gkey != only:
            continue
        dist, shape, factor = gkey
        out = prng.draw([row for _, row in members], shape, dist, dtype,
                        device, -2.0, 2.0)
        out = out * torch.tensor(factor, dtype=dtype).to(device)
        for (i, _), v in zip(members, out.unbind(0)):
            values[i] = v
    for i, leaf in enumerate(leaves):
        if values[i] is None:
            if only is not None:
                values[i] = torch.empty(leaf.shape, dtype=dtype, device="meta")
            else:
                values[i] = (torch.ones if ones(leaf) else torch.zeros)(
                    leaf.shape, dtype=dtype, device=device)
    return _assemble(family, cfg, leaves, values)


@torch.no_grad()
def smoke_init(family: str, cfg, device="cpu",
               only=None) -> Dict[str, torch.Tensor]:
    """The JAX pipeline's bf16 init of `family` for a missing checkpoint
    (rsvldm_tpu/pipeline.py:173-205): leaf i of the flattened tree from
    fold_in(PRNGKey(crc32(family) % 2^31), i); the port's state dict in
    bf16 on `device`. With `only` (a key of `smoke_groups`), that group's
    tensors alone."""
    groups = {("normal", s, f): m
              for (s, f), m in smoke_groups(family, cfg).items()}
    only = None if only is None else ("normal", *only)
    return _init(family, cfg, groups, lambda leaf: leaf.path[-1] == "scale",
                 torch.bfloat16, device, only)


@torch.no_grad()
def flax_init(family: str, cfg, key: prng.Key | None = None, device="cpu",
              only=None) -> Dict[str, torch.Tensor]:
    """Flax's Module.init(key, ...) of `family` (key PRNGKey(crc32(family)
    % 2^31) unless given, as the JAX pipeline's fp32 init): the port's
    state dict in fp32 on `device`. With `only` (a key of `flax_groups`),
    that group's tensors alone."""
    return _init(family, cfg, flax_groups(family, cfg, key),
                 lambda leaf: leaf.init == ONES, torch.float32, device, only)
