"""Wavelet and AdaIN colour correction (rsvldm_tpu/ops/colorfix.py).

Public functions take and return NHWC, as the JAX ones; the blur is a
dilated depthwise 3x3 convolution with replicate padding, computed in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_KERNEL = torch.tensor([[0.0625, 0.125, 0.0625],
                        [0.125, 0.25, 0.125],
                        [0.0625, 0.125, 0.0625]], dtype=torch.float32)


def wavelet_blur(image: torch.Tensor, radius: int) -> torch.Tensor:
    """image: [N, C, H, W] fp32."""
    c = image.shape[1]
    kernel = _KERNEL.to(image)[None, None].repeat(c, 1, 1, 1)
    padded = F.pad(image, (radius,) * 4, mode="replicate")
    return F.conv2d(padded, kernel, dilation=radius, groups=c)


def wavelet_decomposition(image: torch.Tensor, levels: int = 5):
    """(high_freq, low_freq) of [N, C, H, W]; radii 1, 2, ..., 2^(levels-1)."""
    high_freq = torch.zeros_like(image)
    low_freq = image
    for i in range(levels):
        blurred = wavelet_blur(low_freq, 2 ** i)
        high_freq = high_freq + (low_freq - blurred)
        low_freq = blurred
    return high_freq, low_freq


def wavelet_reconstruction(content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """content's high frequencies + style's low frequencies; NHWC."""
    nchw = lambda t: t.permute(0, 3, 1, 2).float()
    content_high, _ = wavelet_decomposition(nchw(content))
    _, style_low = wavelet_decomposition(nchw(style))
    return (content_high + style_low).permute(0, 2, 3, 1)
