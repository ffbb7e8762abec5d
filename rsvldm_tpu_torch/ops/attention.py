"""Multi-head attention dispatch (rsvldm_tpu/ops/attention.py:121-136).

CUDA tensors with both sequence lengths >= 1024 go to the K1 kernel
(ops/flash_attention.py); everything else takes the plain path, a port of
`_xla_attention`: fp32 logits and softmax, probabilities cast to v's dtype,
and zero rows for causal sq > sk. Layout [B, S, H, D].

`FlashAttention` is the counterpart of `_flash_diff`'s custom_vjp: K1 with
lse in the forward, the fused kernel (`flash_attention_bwd`) in the
backward. On CPU tensors it takes the two plain versions. The plain path
stays ordinary autograd.
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention, flash_attention_bwd

FLASH_MIN_SEQ = 1024


class FlashAttention(torch.autograd.Function):
    """q, k, v [B, S, H, D] -> out; saves q, k, v, out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float | None):
        out, lse = flash_attention(q, k, v, causal=causal, scale=scale,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def plain_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None):
    """q: [B, Sq, H, D]; k/v: [B, Sk, H, D] -> [B, Sq, H, D]."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        off = sk - sq
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=off)
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    if causal and off < 0:
        # q rows before the first key have no valid key: zeros, not the
        # uniform softmax of an all-masked row
        probs = probs * mask.any(-1)[None, None, :, None].to(probs.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


def attention(q, k, v, *, causal: bool = False, scale: float | None = None):
    """K1 for CUDA tensors when both sequences are long (`flash_attention`
    goes through `FlashAttention` when a gradient is needed), else plain."""
    if (q.device.type == "cuda" and q.shape[1] >= FLASH_MIN_SEQ
            and k.shape[1] >= FLASH_MIN_SEQ):
        return flash_attention(q, k, v, causal=causal, scale=scale)
    return plain_attention(q, k, v, causal=causal, scale=scale)
