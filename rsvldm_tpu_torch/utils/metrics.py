"""Quality metrics (rsvldm_tpu/utils/metrics.py): PSNR, SSIM, CLIP-IQA, SMS
and LPIPS's loader, on torch tensors on their own device.

PSNR and SSIM (11x11 Gaussian window, sigma 1.5, valid positions: the
torchmetrics defaults) are fp32. CLIP-IQA is softmax(100 cos(image,
[good, bad])) over the prompts "Good photo." / "Bad photo."; SMS, the
semantic mismatch (lower is better), is 1 - cos(CLIP(SR), CLIP(HR)).
Images are NHWC, as in the JAX package.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.image import resize_linear

log = logging.getLogger("rsvldm_torch")


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """a / b [..., H, W, C] in [0, data_range] -> 0-d fp32."""
    mse = torch.mean((a.float() - b.float()) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Mean SSIM over the valid positions of the 11x11 Gaussian window;
    a / b [N, H, W, C] in [0, data_range] -> 0-d fp32."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    c = a.shape[-1]
    kernel = _gaussian_kernel().to(a.device)[None, None].repeat(c, 1, 1, 1)
    a = a.float().permute(0, 3, 1, 2)
    b = b.float().permute(0, 3, 1, 2)
    filt = lambda x: F.conv2d(x, kernel, groups=c)
    mu_a, mu_b = filt(a), filt(b)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    s_aa = filt(a * a) - mu_aa
    s_bb = filt(b * b) - mu_bb
    s_ab = filt(a * b) - mu_ab
    num = (2 * mu_ab + c1) * (2 * s_ab + c2)
    den = (mu_aa + mu_bb + c1) * (s_aa + s_bb + c2)
    return torch.mean(num / den)


class CLIPScorer:
    """CLIP-IQA and SMS over a CLIP image tower and text tower.

    vision_embed(images [N, H, W, 3] in [0, 1]) -> [N, D] image embeds;
    text_embed(tokens [M, 77] int64) -> [M, D] prompt embeds;
    tokenizer(texts, pad_id=0) -> int tokens [M, 77]."""

    GOOD_BAD = ("Good photo.", "Bad photo.")

    def __init__(self, vision_embed, text_embed, tokenizer):
        self.vision_embed = vision_embed
        self.text_embed = text_embed
        self.tokenizer = tokenizer
        toks = tokenizer(list(self.GOOD_BAD), pad_id=0)
        # normalized once: the anchor is the same for every scored image
        self._anchor = self._norm(self.text_embed(
            torch.from_numpy(np.asarray(toks, np.int64))))

    @staticmethod
    def _norm(x: torch.Tensor) -> torch.Tensor:
        return x / torch.linalg.norm(x, dim=-1, keepdim=True)

    def clip_iqa(self, images, logit_scale: float = 100.0) -> torch.Tensor:
        """softmax(logit_scale * cos(image, [good, bad]))[good], [N]."""
        img = self._norm(self.vision_embed(images))
        logits = logit_scale * img @ self._anchor.t()
        return torch.softmax(logits, dim=-1)[:, 0]

    def sms(self, sr, hr) -> torch.Tensor:
        """1 - cos(CLIP(sr), CLIP(hr)), [N]; lower is better."""
        a = self._norm(self.vision_embed(sr))
        b = self._norm(self.vision_embed(hr))
        return 1.0 - torch.sum(a * b, dim=-1)


def load_lpips(ckpt_dir: str | Path, device=None):
    """The LPIPS module (fp32, eval) on `device` (the card unless "cpu")
    when <ckpt_dir>/lpips/vgg16.pth exists, with the heads of
    <ckpt_dir>/lpips/lpips_vgg.pth where it has them (ones elsewhere);
    else None. The .pth files are read directly: no converted cache."""
    from .checkpoint import load_checked, load_torch_state_dict
    from .lpips import LPIPS

    d = Path(ckpt_dir) / "lpips"
    vgg_p = d / "vgg16.pth"
    if not vgg_p.exists():
        return None
    dev = resolve_device(device)
    model = LPIPS()
    sd = {k: v for k, v in model.state_dict().items() if k.startswith("lin")}
    sd.update(load_torch_state_dict(vgg_p))
    lin_p = d / "lpips_vgg.pth"
    if lin_p.exists():
        lin_sd = load_torch_state_dict(lin_p)
        sd.update({k: v for k, v in lin_sd.items() if k in sd})
    load_checked(model, sd, "lpips")
    return model.to(dev).eval().requires_grad_(False)


def calc_metrics(sr, hr, lpips_fn=None) -> dict:
    """PSNR / SSIM (+ LPIPS when `lpips_fn` is given) of [-1, 1] NHWC
    tensors; sr is first resized to hr's grid with the antialiased
    bilinear of the reference's TF.resize default (jax.image.resize
    "linear" with antialias)."""
    sr = torch.as_tensor(sr).float()
    hr = torch.as_tensor(hr).float().to(sr.device)
    if sr.shape != hr.shape:
        sr = resize_linear(sr, tuple(hr.shape[1:3]))
    sr01, hr01 = (sr + 1) / 2, (hr + 1) / 2
    out = {"PSNR": float(psnr(sr01, hr01)), "SSIM": float(ssim(sr01, hr01))}
    if lpips_fn is not None:
        out["LPIPS"] = float(torch.mean(lpips_fn(sr, hr)))
    return out
