"""Weight-only int8 / int4 products (rsvldm_tpu/ops/quant.py) and the K2
kernel.

int8: weights [in, out] with per-output-channel fp32 scales, activations
quantized per token, an exact s8 x s8 -> s32 product (`torch._int_mm`) and
both scales on the int32 accumulator.

int4: two nibbles per byte in the JAX package's plane layout, byte for
byte, so quantized weights interchange: packed int8 [in/2, out], row j holds
weight row j in the low nibble stored +8 and row j + in/2 in the high nibble,
signed. Scales are fp32 [in/group, out]. Activations are quantized per (row,
group), every group sum is an exact integer, both scales apply to it, and
the groups are summed in fp32. `int4_matmul` takes K2
(`csrc/int4_decode.cu`, built with nvcc at first use and bound with ctypes)
for CUDA calls with at most 32 rows, group 128 and in % 256 == 0 (up to
65536 at one row, 32768 at more), the decode steps, in one launch that
quantizes the activations, sums the contraction splits and writes y in its
final type (`k2_plan` picks its grid); everything else, the prefill and
every CPU call, takes
`int4_matmul_grouped`. `int4_matmul_ref` is K2's plain version.

Exactness: a group sum reaches 127 * 8 * 128 = 130048 < 2**24, so a float32
product of the integer-valued operands gives it exactly (TF32 is off, see
device.py); an int8 row sum over 4096 inputs does not fit 24 bits, so the
int8 path takes the int32 product.

Training (QLoRA): `int8_matmul_ste` / `int4_matmul_ste` are the products
above in the forward and a straight-through backward, dx = g @ W_deq^T,
with the weight dequantized only inside the backward
(rsvldm_tpu/ops/quant.py:348-395). The integer product itself has no
gradient, so without them autograd would reach x only through the
activation scale.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..utils import cuda_build

SOURCE = "int4_decode.cu"
K2_GROUP = 128
K2_MAX_ROWS = 32


class QuantizedLinear(NamedTuple):
    """Per-output-channel symmetric int8: q int8 [in, out], scale fp32
    [out], w ~= q * scale."""
    q: torch.Tensor
    scale: torch.Tensor


class Int4Linear(NamedTuple):
    """Plane-packed int4: packed int8 [in/2, out], scale fp32
    [in/group, out]; group = in // scale.shape[0]."""
    packed: torch.Tensor
    scale: torch.Tensor


def _div(t: torch.Tensor, d: float) -> torch.Tensor:
    """t / d, correctly rounded on every device: CUDA divides by a Python
    number as a multiply by its reciprocal, which can differ in the last
    bit, and then the quantized bytes would depend on the device."""
    return t / torch.full((), d, dtype=t.dtype, device=t.device)


def quantize_weight(w: torch.Tensor) -> QuantizedLinear:
    """Symmetric absmax int8 per output channel; w [in, out] (any strides:
    the result is contiguous)."""
    wf = w.float().contiguous()
    scale = _div(wf.abs().amax(dim=0, keepdim=True), 127.0).clamp_min(1e-12)
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return QuantizedLinear(q, scale.reshape(-1))


def quantize_acts(x: torch.Tensor):
    """Per-token (last axis) symmetric absmax int8 -> (xq int8, xs fp32
    with a trailing 1)."""
    xf = x.float()
    s = _div(xf.abs().amax(dim=-1, keepdim=True), 127.0).clamp_min(1e-12)
    return torch.round(xf / s).clamp(-127, 127).to(torch.int8), s


def int8_matmul(x: torch.Tensor, w: QuantizedLinear,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """y = x @ dequant(w): exact int32 product, scales on the accumulator.
    CUDA's int8 GEMM wants more than 16 rows, so short inputs are padded."""
    xq, xs = quantize_acts(x)
    lead, inf = xq.shape[:-1], xq.shape[-1]
    a = xq.reshape(-1, inf)
    r = a.shape[0]
    if a.is_cuda and r <= 16:
        a = F.pad(a, (0, 0, 0, 17 - r))
    acc = torch._int_mm(a, w.q)[:r]
    y = acc.float() * xs.reshape(r, 1) * w.scale
    return y.reshape(*lead, -1).to(out_dtype)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 [in, out] with values in [-8, 7] -> int8 [in/2, out], plane
    layout."""
    half = q.shape[0] // 2
    lo = (q[:half].to(torch.int8) + 8) & 0xF
    hi = q[half:].to(torch.int8)
    return ((hi << 4) | lo).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """int8 [in/2, out] -> int8 [in, out] (the signed nibble planes)."""
    lo = (packed & 0xF) - 8
    hi = packed >> 4  # arithmetic shift: sign-extends
    return torch.cat([lo, hi], dim=0).to(torch.int8)


def quantize_weight_int4(w: torch.Tensor, group: int = 128) -> Int4Linear:
    """Symmetric absmax RTN int4 per (group of `group` input rows, output
    channel); w [in, out], in divisible by 2 and by the group (any
    strides: the result is contiguous)."""
    wf = w.float().contiguous()
    inf, out = wf.shape
    group = min(group, inf)
    if inf % group or inf % 2:
        raise ValueError(f"quantize_weight_int4: in={inf} does not split "
                         f"into groups of {group}")
    g = wf.reshape(inf // group, group, out)
    scale = _div(g.abs().amax(dim=1, keepdim=True), 7.0).clamp_min(1e-12)
    q = torch.round(g / scale).clamp(-7, 7).to(torch.int8)
    return Int4Linear(pack_int4(q.reshape(inf, out)),
                      scale.reshape(inf // group, out))


def quantize_acts_grouped(x: torch.Tensor, group: int):
    """Per-(token, group of `group` features) symmetric absmax int8:
    x [..., in] -> (xq int8 [..., Gb, group], xs fp32 [..., Gb, 1])."""
    xf = x.float().reshape(*x.shape[:-1], x.shape[-1] // group, group)
    s = _div(xf.abs().amax(dim=-1, keepdim=True), 127.0).clamp_min(1e-12)
    return torch.round(xf / s).clamp(-127, 127).to(torch.int8), s


def int4_matmul_grouped(x: torch.Tensor, w: Int4Linear,
                        out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain grouped path (`_int4_matmul_xla`): unpack, an exact
    integer sum per group, both scales on it, sum over groups."""
    inf = 2 * w.packed.shape[0]
    gb = w.scale.shape[0]
    group = inf // gb
    lead = x.shape[:-1]
    xq, xs = quantize_acts_grouped(x.reshape(-1, inf), group)
    q = unpack_int4(w.packed).reshape(gb, group, -1)
    y = torch.zeros((xq.shape[0], q.shape[-1]), dtype=torch.float32,
                    device=x.device)
    for g in range(gb):
        acc = xq[:, g].float() @ q[g].float()  # integer-valued, exact
        y += acc * xs[:, g] * w.scale[g]
    return y.reshape(*lead, -1).to(out_dtype)


def int4_matmul_ref(x: torch.Tensor, w: Int4Linear,
                    out_dtype=torch.float32) -> torch.Tensor:
    """K2's plain version: the function K2 computes, for the weights K2
    takes (group 128, in % 256 == 0), in plain PyTorch."""
    inf = 2 * w.packed.shape[0]
    if inf // w.scale.shape[0] != K2_GROUP or inf % (2 * K2_GROUP):
        raise ValueError(f"int4_matmul_ref: K2 takes group {K2_GROUP} and "
                         f"in % 256 == 0, got in={inf}, "
                         f"{w.scale.shape[0]} groups")
    return int4_matmul_grouped(x, w, out_dtype)


K2_MAX_PAIRS = 16      # contraction pairs of one block (its prologue's codes)
K2_MAX_SPLITS = 16     # blocks of one cluster
K2_TILES = (256, 128, 64)  # column tiles, widest first
K2_MIN_BLOCKS = 132    # one block per SM of an H100, where no card is asked


class K2Plan(NamedTuple):
    """K2's grid: `tn` output columns per block, `rb` rows per chunk (one
    grid layer each) and `splits` contraction ranges of whole pairs (128
    packed rows: one low and one high scale group)."""
    tn: int
    rb: int
    splits: int


@functools.lru_cache(maxsize=None)
def k2_plan(r: int, inf: int, out: int,
            min_blocks: int = K2_MIN_BLOCKS) -> K2Plan | None:
    """The widest column tile, then the fewest splits, that give at least
    `min_blocks` blocks (one per SM) for x [r, inf] @ W [inf, out]; None
    where no split leaves at most 16 pairs a block (K2 does not take it).
    The splits of a tile are one cluster, of at most 8 blocks where that
    reaches `min_blocks`, else 16 (one row only: a block of more rows may
    fill an SM). Splits that divide the pair count come first, for even
    ranges; where none fits, any count does. Where nothing reaches
    `min_blocks`: 64 columns and the most splits. (On an H100, clusters of
    16 made q/o and down slower than clusters of 8 over narrower tiles.)"""
    rb = 1 if r == 1 else 2 if r == 2 else 4
    chunks = -(-r // rb)
    npairs = inf // (2 * K2_GROUP)
    limit = K2_MAX_SPLITS if rb == 1 else 8
    fits = [s for s in range(1, min(npairs, limit) + 1)
            if -(-npairs // s) <= K2_MAX_PAIRS]
    splits = [s for s in fits if npairs % s == 0] or fits
    if not splits:
        return None
    for most in (8, limit) if limit > 8 else (8,):
        for tn in K2_TILES:
            for s in splits:
                if s <= most and -(-out // tn) * chunks * s >= min_blocks:
                    return K2Plan(tn, rb, s)
    return K2Plan(K2_TILES[-1], rb, splits[-1])


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _bind():
    lib = cuda_build.load(SOURCE)
    fn = lib.rsv_int4_decode
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


_K2_X = (torch.bfloat16, torch.float32)


def _k2(x: torch.Tensor, w: Int4Linear,
        out_dtype=torch.bfloat16) -> torch.Tensor:
    """Launch K2 once: x bf16 or fp32 [R, in] (1 <= R <= 32) -> y
    `out_dtype` (bf16 or fp32) [R, out]; the activation quantization, the
    split sum and the cast happen inside the kernel, which allocates
    nothing."""
    packed, scale = w.packed, w.scale
    for name, t in (("x", x), ("packed", packed), ("scale", scale)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"int4_matmul: {name} is on {t.device}, K2 "
                             "takes CUDA tensors on one device")
        if not t.is_contiguous():
            raise TypeError(f"int4_matmul: K2 takes a contiguous {name}")
    if (x.dtype not in _K2_X or out_dtype not in _K2_X
            or packed.dtype != torch.int8 or scale.dtype != torch.float32):
        raise TypeError(f"int4_matmul: K2 takes x and y in bf16 or fp32, "
                        f"int8 packed and fp32 scales, got x {x.dtype}, y "
                        f"{out_dtype}, packed {packed.dtype}, scale "
                        f"{scale.dtype}")
    if x.dim() != 2:
        raise ValueError(f"int4_matmul: K2 takes x [R, in], got "
                         f"{tuple(x.shape)}")
    r, inf = x.shape
    out = packed.shape[1]
    if (not 0 < r <= K2_MAX_ROWS or inf % (2 * K2_GROUP)
            or packed.shape[0] * 2 != inf
            or scale.shape != (inf // K2_GROUP, out)):
        raise ValueError(f"int4_matmul: K2 shapes x {tuple(x.shape)}, packed "
                         f"{tuple(packed.shape)}, scale {tuple(scale.shape)} "
                         "do not fit")
    plan = k2_plan(r, inf, out, _sm_count(x.device.index))
    if plan is None:
        raise ValueError(f"int4_matmul: K2 takes at most "
                         f"{K2_MAX_PAIRS * K2_MAX_SPLITS} group pairs at one "
                         f"row and {K2_MAX_PAIRS * 8} at more, got in={inf} "
                         f"at {r} rows")
    y = torch.empty((r, out), dtype=out_dtype, device=x.device)
    vec = int(out % 16 == 0 and packed.data_ptr() % 16 == 0)
    fn = _bind()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16),
                packed.data_ptr(), scale.data_ptr(), y.data_ptr(),
                int(out_dtype == torch.bfloat16), r, inf, out, plan.tn,
                plan.rb, plan.splits, vec, stream)
    if rc != 0:
        raise RuntimeError(f"int4_matmul: K2 launch failed, cudaError {rc}")
    return y


def int4_matmul(x: torch.Tensor, w: Int4Linear,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """y = x @ dequant(w). CUDA calls with at most 32 rows, group 128,
    in % 256 == 0 and a K2 plan (`k2_plan`: in <= 65536 at one row, 32768
    at more) launch K2, one kernel and no other device op (no rows: no
    launch); the rest take `int4_matmul_grouped`.
    `int4_matmul.launches` counts K2 launches."""
    inf = 2 * w.packed.shape[0]
    gb = w.scale.shape[0]
    lead = x.shape[:-1]
    r = x.numel() // inf
    if (x.device.type == "cuda" and r <= K2_MAX_ROWS
            and inf // gb == K2_GROUP and inf % (2 * K2_GROUP) == 0
            and k2_plan(max(r, 1), inf, w.packed.shape[1]) is not None):
        if r == 0:
            return x.new_empty((*lead, w.packed.shape[1]), dtype=out_dtype)
        y = _k2(x.reshape(r, inf), w, out_dtype)
        int4_matmul.launches += 1
        return y.reshape(*lead, -1)
    return int4_matmul_grouped(x, w, out_dtype)


int4_matmul.launches = 0


def dequantize_int8(w: QuantizedLinear) -> torch.Tensor:
    """fp32 [in, out] = q * scale."""
    return w.q.float() * w.scale


def dequantize_int4(w: Int4Linear) -> torch.Tensor:
    """fp32 [in, out] = nibble * its group's scale."""
    group = 2 * w.packed.shape[0] // w.scale.shape[0]
    return (unpack_int4(w.packed).float()
            * w.scale.repeat_interleave(group, dim=0))


class _QuantSTE(torch.autograd.Function):
    """Forward: the int8 or int4 product. Backward: dx = g @ dequant(w)^T;
    the weights and scales get no gradient. On the CPU the product is fp32,
    as JAX's einsum; on the card its operands are x's dtype (bf16) with
    fp32 accumulation in torch.matmul."""

    @staticmethod
    def forward(ctx, x, planes, scale, mode, out_dtype):
        ctx.save_for_backward(planes, scale)
        ctx.mode, ctx.x_dtype = mode, x.dtype
        if mode == "int8":
            return int8_matmul(x, QuantizedLinear(planes, scale), out_dtype)
        return int4_matmul(x, Int4Linear(planes, scale), out_dtype)

    @staticmethod
    def backward(ctx, g):
        planes, scale = ctx.saved_tensors
        w = (dequantize_int8(QuantizedLinear(planes, scale)) if ctx.mode == "int8"
             else dequantize_int4(Int4Linear(planes, scale)))
        cd = torch.float32 if g.device.type == "cpu" else ctx.x_dtype
        dx = torch.matmul(g.to(cd), w.to(cd).t())
        return dx.to(ctx.x_dtype), None, None, None, None


def int8_matmul_ste(x: torch.Tensor, w: QuantizedLinear,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """`int8_matmul` with the straight-through backward dx = g @ W_deq^T."""
    return _QuantSTE.apply(x, w.q, w.scale, "int8", out_dtype)


def int4_matmul_ste(x: torch.Tensor, w: Int4Linear,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """`int4_matmul` (K2 for decode shapes) with the straight-through
    backward dx = g @ W_deq^T."""
    return _QuantSTE.apply(x, w.packed, w.scale, "int4", out_dtype)
