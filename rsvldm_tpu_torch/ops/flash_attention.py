"""Flash attention: the K1 (forward), K3 and K4 (backward) CUDA kernels and
their plain versions.

Counterpart of rsvldm_tpu/ops/flash_attention.py (`flash_attention`, the
Pallas kernel `_flash_kernel`; `flash_attention_bwd`, the Pallas kernels
`_flash_bwd_kv_kernel` and `_flash_bwd_q_kernel`). The kernels are
`csrc/flash_fwd.cu` (a persistent, warp-specialised TMA + wgmma kernel
built on `csrc/hopper.cuh`) and `csrc/flash_bwd.cu`, built with nvcc at
first use and bound with ctypes; their source notes give the design and
the bound on an H100. `flash_attention_ref` and `flash_attention_bwd_ref` are plain
PyTorch computing the same functions. CPU tensors take them; CUDA tensors
launch the kernels or raise. Layout [B, S, H, D] throughout.

A gradient through K1 goes through `ops/attention.py::FlashAttention`, whose
backward is K3 and K4: `flash_attention` sends CUDA calls that need a
gradient there, and raises for the calls it cannot differentiate.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..utils import cuda_build

SOURCE = "flash_fwd.cu"
BWD_SOURCE = "flash_bwd.cu"
NEG_INF = -1e30
LOG2E = math.log2(math.e)
LN2 = math.log(2.0)
HEAD_DIMS = (64, 128)


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


def _bind():
    lib = cuda_build.load(SOURCE)
    fn = lib.rsv_flash_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


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
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q/k/v on different devices")
    if sq == 0 or k.shape[1] == 0 or not 0 <= kv_len <= k.shape[1]:
        raise ValueError(f"flash_attention: empty sequence or kv_len "
                         f"{kv_len} outside [0, {k.shape[1]}]")


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None, kv_len: int | None = None,
                    return_lse: bool = False):
    """K1 on CUDA tensors, `flash_attention_ref` on CPU tensors (see there
    for the semantics). `flash_attention.launches` counts kernel launches.

    A CUDA call that needs a gradient goes through the autograd Function
    whose backward is K3 and K4; one that asks for lse or masks keys by
    kv_len has no backward and raises."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                   kv_len=kv_len, return_lse=return_lse)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        if return_lse or kv_len not in (None, k.shape[1]):
            raise ValueError("flash_attention: return_lse and kv_len have no "
                             "backward; call with neither to differentiate")
        from .attention import FlashAttention
        return FlashAttention.apply(q, k, v, causal, scale)
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    _check(q, k, v, kv_len)
    b, sq, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    fn = _bind()
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
    return (out, lse) if return_lse else out


flash_attention.launches = 0


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
    kv, q = lib.rsv_flash_bwd_kv, lib.rsv_flash_bwd_q
    if kv.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        kv.argtypes = [p] * 8 + [i] * 6 + [ctypes.c_float, p]
        q.argtypes = [p] * 7 + [i] * 6 + [ctypes.c_float, p]
        kv.restype = q.restype = ctypes.c_int
    return kv, q


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = False,
                        scale: float | None = None):
    """K3 (dK, dV) then K4 (dQ) on CUDA tensors, `flash_attention_bwd_ref`
    on CPU tensors. out and lse [B, H, Sq] come from K1 on the same inputs.
    `flash_attention_bwd.k3_launches` / `.k4_launches` count launches."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                       scale=scale)
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
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("K3", q, k, v, do, lse, delta, (dk, dv), causal, scale)
    flash_attention_bwd.k3_launches += 1
    _launch_bwd("K4", q, k, v, do, lse, delta, (dq,), causal, scale)
    flash_attention_bwd.k4_launches += 1
    return dq, dk, dv


def _launch_bwd(which, q, k, v, do, lse, delta, outs, causal, scale):
    """One launch of K3 (outs = (dk, dv)) or K4 (outs = (dq,)) on inputs
    `flash_attention_bwd` has checked; delta [B, H, Sq] fp32."""
    kv_fn, q_fn = _bind_bwd()
    b, sq, h, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = (kv_fn if which == "K3" else q_fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs),
            b, h, sq, k.shape[1], d, int(causal), float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd: {which} launch failed, "
                           f"cudaError {rc}")


flash_attention_bwd.k3_launches = 0
flash_attention_bwd.k4_launches = 0
