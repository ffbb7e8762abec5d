"""The int4 weight-only product the captioner's decoder is configured with
(LlavaConfig quant "int4"), in plain torch: symmetric absmax RTN int4 per
(group of 128 input rows, output channel), plane-packed as the port keeps
it; activations quantized per (row, group) to int8; each group's integer
sum exact in fp32, both scales on it, the groups summed in fp32. A frozen
copy of the port's plain grouped path (ops/quant.py), which its K2 kernel
computes on the card for decode rows."""

from __future__ import annotations

from typing import NamedTuple

import torch

GROUP = 128
FP8_MAX = 448.0


class Int4Linear(NamedTuple):
    """packed int8 [in/2, out] (row j: weight row j in the low nibble +8,
    row j + in/2 in the high nibble), scale fp32 [in/group, out]."""
    packed: torch.Tensor
    scale: torch.Tensor


def _div(t: torch.Tensor, d: float) -> torch.Tensor:
    """t / d correctly rounded on every device."""
    return t / torch.full((), d, dtype=t.dtype, device=t.device)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    half = q.shape[0] // 2
    lo = (q[:half].to(torch.int8) + 8) & 0xF
    hi = q[half:].to(torch.int8)
    return ((hi << 4) | lo).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    lo = (packed & 0xF) - 8
    hi = packed >> 4
    return torch.cat([lo, hi], dim=0).to(torch.int8)


def quantize_weight_int4(w: torch.Tensor, group: int = GROUP) -> Int4Linear:
    """w [in, out] -> its int4 weights."""
    wf = w.float().contiguous()
    inf, out = wf.shape
    group = min(group, inf)
    g = wf.reshape(inf // group, group, out)
    scale = _div(g.abs().amax(dim=1, keepdim=True), 7.0).clamp_min(1e-12)
    q = torch.round(g / scale).clamp(-7, 7).to(torch.int8)
    return Int4Linear(pack_int4(q.reshape(inf, out)),
                      scale.reshape(inf // group, out))


def quantize_acts_grouped(x: torch.Tensor, group: int, qmax: int = 127):
    xf = x.float().reshape(*x.shape[:-1], x.shape[-1] // group, group)
    s = _div(xf.abs().amax(dim=-1, keepdim=True), float(qmax)).clamp_min(1e-12)
    return torch.round(xf / s).clamp(-qmax, qmax).to(torch.int8), s


def int4_matmul(x: torch.Tensor, w: Int4Linear,
                act_qmax: int = 127) -> torch.Tensor:
    """x [..., in] -> fp32 [..., out] = x @ dequant(w), activations
    quantized per (row, group) to +-act_qmax (127: int8; the control's
    7: int4)."""
    inf = 2 * w.packed.shape[0]
    gb = w.scale.shape[0]
    group = inf // gb
    lead = x.shape[:-1]
    xq, xs = quantize_acts_grouped(x.reshape(-1, inf), group, act_qmax)
    q = unpack_int4(w.packed).reshape(gb, group, -1)
    y = torch.zeros((xq.shape[0], q.shape[-1]), dtype=torch.float32,
                    device=x.device)
    for g in range(gb):
        acc = xq[:, g].float() @ q[g].float()
        y += acc * xs[:, g] * w.scale[g]
    return y.reshape(*lead, -1)


def fp8(t: torch.Tensor, dim=None) -> torch.Tensor:
    """t rounded to fp8 e4m3 under an absmax scale (per tensor, or over
    `dim`), returned in fp32."""
    amax = (t.abs().amax() if dim is None
            else t.abs().amax(dim=dim, keepdim=True))
    s = amax.clamp_min(1e-12) / FP8_MAX
    return (t.float() / s).to(torch.float8_e4m3fn).float() * s
