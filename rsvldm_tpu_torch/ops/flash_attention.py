"""Flash attention: the K1 (forward) and fused backward CUDA kernels and
their plain versions.

Counterpart of rsvldm_tpu/ops/flash_attention.py (`flash_attention`, the
Pallas kernel `_flash_kernel`; `flash_attention_bwd`, the Pallas kernels
`_flash_bwd_kv_kernel` and `_flash_bwd_q_kernel`, which one fused kernel
replaces). The kernels are `csrc/flash_fwd.cu` and `csrc/flash_bwd.cu`,
and at D > 256 `csrc/flash_wide.cu`: warp-specialised TMA + wgmma kernels
built on `csrc/hopper.cuh`, with nvcc at first use, and bound with ctypes;
their source notes give the design and the bound on an H100. `flash_attention_ref` and
`flash_attention_bwd_ref` are plain PyTorch computing the same functions.
CPU tensors take them; CUDA tensors launch the kernels or raise. Layout
[B, S, H, D] throughout.

A gradient through K1 goes through `ops/attention.py::FlashAttention`, whose
backward is the fused kernel: `flash_attention` sends CUDA calls that need
a gradient there, and raises for the calls it cannot differentiate.

Head dims: K1 and the fused backward are built for 64, 128 and 256 (JAX's
kernels take any D). Any other D <= 256 (MLCD's 104) runs zero-padded along
D to the next of them with the scale of the true D, and its results are
sliced back (`with_padded_head_dim`, exact: zero columns add 0 to every
score and give 0 output and gradient columns). A D above 256 goes to the
wide kernels of `csrc/flash_wide.cu` (a forward, and a backward of a
prologue and one kernel, in one C call), built for any multiple of 64;
other D above 256 are padded to the next multiple of 64 the same way. A
D that nothing serves (D <= 0) raises ValueError: a CUDA call never falls
back to the plain version. `launches` counts every launch at every D;
`flash_attention.launches_wide` and `flash_attention_bwd.launches_wide`
those of the wide kernels, `flash_attention.launches_d256` and
`flash_attention_bwd.launches_d256` those of the D=256 kernels
(`flash_fwd_d256_kernel`, `flash_bwd_d256_kernel`, which D padded to 256
runs too).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ..utils import cuda_build

SOURCE = "flash_fwd.cu"
BWD_SOURCE = "flash_bwd.cu"
WIDE_SOURCE = "flash_wide.cu"
NEG_INF = -1e30
LOG2E = math.log2(math.e)
LN2 = math.log(2.0)
# K1's instantiations (csrc/flash_fwd.cu) and the fused backward's
# (csrc/flash_bwd.cu)
HEAD_DIMS = (64, 128, 256)
BWD_Q_TILE = 64  # queries per tile of the backward kernel (csrc Q_TILE)
WIDE_STEP = 64  # the wide kernels take D > 256 in multiples of this (csrc BOX_COLS)


def flash_attention_ref(q, k, v, *, causal: bool = False,
                        scale: float | None = None, kv_len: int | None = None,
                        return_lse: bool = False):
    """q: [B, Sq, H, D]; k/v: [B, Sk, H, D] -> [B, Sq, H, D] (q's dtype).

    Keys at or past `kv_len` (default Sk) are padding. Causal is suffix-
    aligned to the valid keys: q row r sees keys <= r + kv_len - Sq. Rows
    with no valid key are zeros. lse: [B, H, Sq] fp32, natural log."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    kv_len = sk if kv_len is None else int(kv_len)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (scale * LOG2E)
    key = torch.arange(sk, device=q.device)
    valid = (key < kv_len)[None, :]
    if causal:
        row = torch.arange(sq, device=q.device)[:, None]
        valid = valid & (key[None, :] <= row + (kv_len - sq))
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    out = (pv / l).permute(0, 2, 1, 3).to(q.dtype)
    if return_lse:
        return out, (m * LN2 + torch.log(l))[..., 0]
    return out


def padded_head_dim(d: int) -> int | None:
    """The head dim K1 and the fused backward run a true head dim `d` at:
    the least of HEAD_DIMS that is >= d, past 256 the next multiple of
    WIDE_STEP (the wide kernels), by zero padding; None for d <= 0."""
    if d <= 0:
        return None
    return next((dp for dp in HEAD_DIMS if dp >= d),
                -(-d // WIDE_STEP) * WIDE_STEP)


def is_wide(d: int) -> bool:
    """Whether a CUDA call at the (padded) head dim d runs the kernels of
    csrc/flash_wide.cu rather than flash_fwd.cu / flash_bwd.cu."""
    return d > HEAD_DIMS[-1]


def with_padded_head_dim(fn, q, k, v, *rest, scale: float | None = None,
                         **kw):
    """fn(q, k, v, *rest, scale=..., **kw) with every [B, S, H, D] argument
    zero-padded along D to `padded_head_dim(D)`, the softmax scale kept at
    1 / sqrt(D) of the true D (or the given one), and every [..., D'] result
    sliced back to D. lse ([B, H, Sq]) passes through: the padded columns
    add nothing to any score. The CUDA wrappers call it; the CPU tests run
    it around the plain versions."""
    d = q.shape[-1]
    dp = padded_head_dim(d)
    if dp is None:
        raise ValueError(f"flash_attention: head dim {d} cannot be served")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if dp == d:
        return fn(q, k, v, *rest, scale=scale, **kw)
    pad = lambda x: (F.pad(x, (0, dp - d)) if x is not None and x.dim() == 4
                     and x.shape[-1] == d else x)
    res = fn(*(pad(x) for x in (q, k, v) + rest), scale=scale, **kw)
    cut = lambda x: (x[..., :d].contiguous() if x is not None and x.dim() == 4
                     and x.shape[-1] == dp else x)
    return tuple(cut(x) for x in res) if isinstance(res, tuple) else cut(res)


def _bind():
    lib = cuda_build.load(SOURCE)
    fn = lib.rsv_flash_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _bind_wide():
    """(forward, backward) of csrc/flash_wide.cu."""
    lib = cuda_build.load(WIDE_SOURCE)
    fwd, bwd = lib.rsv_flash_wide_fwd, lib.rsv_flash_wide_bwd
    if fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
        bwd.argtypes = [p] * 10 + [i] * 6 + [ctypes.c_float, p]
        fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _check(q, k, v, kv_len):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {x.device}, "
                             "q/k/v must all be CUDA tensors")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: K1 takes bf16, {name} is "
                            f"{x.dtype}")
        if x.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be [B, S, H, D]")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous and "
                             "16-byte aligned")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if padded_head_dim(d) != d:
        raise ValueError(f"flash_attention: head dim {d} is not one the "
                         f"kernels are built for ({HEAD_DIMS}, multiples of "
                         f"{WIDE_STEP} above 256)")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q/k/v on different devices")
    if sq == 0 or k.shape[1] == 0 or not 0 <= kv_len <= k.shape[1]:
        raise ValueError(f"flash_attention: empty sequence or kv_len "
                         f"{kv_len} outside [0, {k.shape[1]}]")


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None, kv_len: int | None = None,
                    return_lse: bool = False):
    """K1 on CUDA tensors, `flash_attention_ref` on CPU tensors (see there
    for the semantics). `flash_attention.launches` counts kernel launches,
    `flash_attention.launches_wide` those at D > 256 (csrc/flash_wide.cu),
    `flash_attention.launches_d256` those at D = 256 (padded D included).

    A CUDA call that needs a gradient goes through the autograd Function
    whose backward is the fused backward kernel; one that asks for lse or
    masks keys by kv_len has no backward and raises."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                   kv_len=kv_len, return_lse=return_lse)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        if return_lse or kv_len not in (None, k.shape[1]):
            raise ValueError("flash_attention: return_lse and kv_len have no "
                             "backward; call with neither to differentiate")
        from .attention import FlashAttention
        return FlashAttention.apply(q, k, v, causal, scale)
    if padded_head_dim(q.shape[-1]) != q.shape[-1]:
        return with_padded_head_dim(flash_attention, q, k, v, causal=causal,
                                    scale=scale, kv_len=kv_len,
                                    return_lse=return_lse)
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    _check(q, k, v, kv_len)
    b, sq, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    wide = is_wide(d)
    fn = _bind_wide()[0] if wide else _bind()
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if lse is not None else None, b, h, sq,
                k.shape[1], d, kv_len, int(causal), float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: K1 launch failed, cudaError {rc}")
    flash_attention.launches += 1
    flash_attention.launches_wide += wide
    flash_attention.launches_d256 += d == 256
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.launches_wide = 0
flash_attention.launches_d256 = 0


# ---------------------------------------------------------------- backward
def _valid_mask(sq, sk, causal, device):
    """[Sq, Sk] bool: key <= row + Sk - Sq when causal, else all."""
    if not causal:
        return torch.ones((sq, sk), dtype=torch.bool, device=device)
    return torch.ones((sq, sk), dtype=torch.bool, device=device).tril(sk - sq)


def flash_attention_bwd_ref(q, k, v, out, lse, do, *, causal: bool = False,
                            scale: float | None = None):
    """(q, k, v, out, lse [B, H, Sq], dO) -> (dq, dk, dv), in plain
    PyTorch, fp32 sums: p rebuilt from lse in base 2 and masked to exact
    zeros (so rows with no valid key give zero gradients),
    ds = p * (dP - delta) * scale with delta = rowsum(dO * O); p and ds are
    cast to the inputs' dtype before their products, as K3 and K4 do."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * (scale * LOG2E)
    p = torch.exp2(s - lse.float()[..., None] * LOG2E)
    p = torch.where(_valid_mask(sq, sk, causal, q.device), p, 0.0)
    delta = (dof * out.float()).sum(-1).transpose(1, 2)  # [B, H, Sq]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), qf)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bind_bwd():
    lib = cuda_build.load(BWD_SOURCE)
    prep, main = lib.rsv_flash_bwd_prep, lib.rsv_flash_bwd
    if main.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        prep.argtypes = [p] * 5 + [i] * 4 + [p]
        main.argtypes = [p] * 8 + [i] * 6 + [ctypes.c_float, p]
        prep.restype = main.restype = ctypes.c_int
    return prep, main


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = False,
                        scale: float | None = None):
    """The fused backward kernel (dq, dk and dv in one launch, after its
    delta prologue) on CUDA tensors, `flash_attention_bwd_ref` on CPU
    tensors. out and lse [B, H, Sq] come from K1 on the same inputs.
    dq is summed in an fp32 workspace by reduce-adds whose order changes
    from run to run, and so may its last bits; at every head dim.
    At D > 256 one call of csrc/flash_wide.cu runs its prologue and its
    kernel, which adds dq into the workspace as the others do.
    `flash_attention_bwd.launches` counts calls at every head dim,
    `flash_attention_bwd.launches_d256` those of the D=256 kernel and
    `flash_attention_bwd.launches_wide` those at D > 256."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                       scale=scale)
    if padded_head_dim(q.shape[-1]) != q.shape[-1]:
        return with_padded_head_dim(flash_attention_bwd, q, k, v, out, lse, do,
                                    causal=causal, scale=scale)
    _check(q, k, v, k.shape[1])
    b, sq, h, d = q.shape
    for name, x in (("out", out), ("do", do)):
        if (x.shape != q.shape or x.dtype != torch.bfloat16
                or x.device != q.device or not x.is_contiguous()):
            raise ValueError(f"flash_attention_bwd: {name} must be a "
                             f"contiguous bf16 {tuple(q.shape)} on {q.device}")
    if (lse.shape != (b, h, sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous fp32 "
                         f"{(b, h, sq)} on {q.device}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if is_wide(d):
        return _bwd_wide(q, k, v, out, lse, do, causal, scale)
    aux, dq_acc = _bwd_prep(out, do, lse)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_kernel(q, k, v, do, aux, dq_acc, dk, dv, causal, scale)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_d256 += d == 256
    return dq_acc.to(q.dtype), dk, dv


def _bwd_wide(q, k, v, out, lse, do, causal, scale):
    """csrc/flash_wide.cu's backward on checked inputs: (dq, dk, dv)."""
    b, sq, h, d = q.shape
    aux = torch.empty((2, b * h, sq), dtype=torch.float32, device=q.device)
    dq_acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd(_bind_wide()[1], "wide", q.device, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                aux.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), b, h, sq, k.shape[1], d, int(causal),
                float(scale))
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_wide += 1
    return dq_acc.to(q.dtype), dk, dv


def _bwd_prep(out, do, lse):
    """The prologue on checked inputs: (aux, dq_acc), aux [2, B*H, Sq
    rounded up to BWD_Q_TILE] fp32 holding lse*log2(e) and
    delta = rowsum(dO * O), dq_acc the zeroed fp32 dQ workspace."""
    b, sq, h, d = out.shape
    sq_pad = -(-sq // BWD_Q_TILE) * BWD_Q_TILE
    aux = torch.empty((2, b * h, sq_pad), dtype=torch.float32,
                      device=out.device)
    dq_acc = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    _launch_bwd(_bind_bwd()[0], "prologue", out.device, out.data_ptr(),
                do.data_ptr(), lse.data_ptr(), aux.data_ptr(),
                dq_acc.data_ptr(), b, h, sq, d)
    return aux, dq_acc


def _bwd_kernel(q, k, v, do, aux, dq_acc, dk, dv, causal, scale):
    """One launch of the fused kernel on checked inputs and the prologue's
    aux and dq_acc: adds dQ into dq_acc, writes dk and dv."""
    b, sq, h, d = q.shape
    _launch_bwd(_bind_bwd()[1], "kernel", q.device, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), do.data_ptr(), aux.data_ptr(),
                dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, sq,
                k.shape[1], d, int(causal), float(scale))


def _launch_bwd(fn, name, device, *args):
    """fn(*args, stream) on `device`'s current stream; raises on a refused
    launch."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd: {name} launch failed, "
                           f"cudaError {rc}")


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_d256 = 0
flash_attention_bwd.launches_wide = 0
