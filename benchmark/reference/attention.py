"""Multi-head attention in plain torch, layout [B, S, H, D]: fp32 logits
and softmax, probabilities cast to v's dtype, zero rows for causal
sq > sk (the port's ops/attention.py `plain_attention`, which its K1
kernel computes on the card where both sequences reach FLASH_MIN_SEQ).

`recording()` collects the (B, Sq, Sk, H, D, causal) of every call that
the port sends to K1, so the benchmark counts K1's work from the
reference's own shapes (benchmark/harness/counting.py)."""

from __future__ import annotations

import contextlib
import contextvars

import torch

FLASH_MIN_SEQ = 1024
_CALLS = contextvars.ContextVar("long_attention_calls", default=None)


@contextlib.contextmanager
def recording():
    """Within it, every attention call with both sequences at least
    FLASH_MIN_SEQ appends its shape to the yielded list."""
    calls: list = []
    token = _CALLS.set(calls)
    try:
        yield calls
    finally:
        _CALLS.reset(token)


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
        probs = probs * mask.any(-1)[None, None, :, None].to(probs.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


def attention(q, k, v, *, causal: bool = False, scale: float | None = None):
    calls = _CALLS.get()
    if (calls is not None and q.shape[1] >= FLASH_MIN_SEQ
            and k.shape[1] >= FLASH_MIN_SEQ):
        b, sq, h, d = q.shape
        calls.append((b, sq, k.shape[1], h, d, causal))
    return plain_attention(q, k, v, causal=causal, scale=scale)
