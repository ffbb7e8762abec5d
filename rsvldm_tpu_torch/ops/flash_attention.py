"""Flash-attention forward: the K1 CUDA kernel and its plain version.

Counterpart of rsvldm_tpu/ops/flash_attention.py (`flash_attention`, the
Pallas kernel `_flash_kernel`). The kernel is `csrc/flash_fwd.cu`, built with
nvcc at first use and bound with ctypes; its source note gives the design
and the bound on an H100. `flash_attention_ref` is plain PyTorch computing
the same function. CPU tensors take it; CUDA tensors launch the kernel or
raise. Layout [B, S, H, D] throughout.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..utils import cuda_build

SOURCE = "flash_fwd.cu"
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
    for the semantics). `flash_attention.launches` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                   kv_len=kv_len, return_lse=return_lse)
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
