"""LPIPS perceptual distance over the VGG16 trunk (rsvldm_tpu/utils/lpips.py).

Distance = sum over the 5 VGG16 relu stages of mean_hw sum_c |w_c| (a^ -
b^)^2, where a^ and b^ are the stage's features unit-normalized over
channels (with 1e-10 under the root) and w the stage's learned 1x1 head
(ones where the file has none). Inputs are shifted and scaled as LPIPS's
ScalingLayer does.

Names are the published ones, so the files load with no converter:
torchvision's vgg16().features (`features.{0,2,5,7,10,12,14,17,19,21,24,
26,28}` the 13 convs) and LPIPS's heads (`lin{i}.model.1.weight`
[1, C, 1, 1]). Images come NHWC, as in the JAX package; the trunk runs
NCHW.
"""

from __future__ import annotations

import torch
from torch import nn

# conv channels per stage, a 2x2 max-pool between stages
VGG16_STAGES = [(64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
                (512, 512, 512)]
# LPIPS's ScalingLayer
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """The VGG16 conv trunk as torchvision's `features` Sequential (13
    convs with ReLUs, max-pools between the 5 stages and after the last);
    `stages` returns the 5 post-ReLU stage outputs, NCHW."""

    def __init__(self):
        super().__init__()
        layers, c_in = [], 3
        for stage in VGG16_STAGES:
            for ch in stage:
                layers += [nn.Conv2d(c_in, ch, 3, padding=1), nn.ReLU()]
                c_in = ch
            layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)

    def stages(self, x: torch.Tensor) -> list:
        """x [N, 3, H, W] -> the 5 stage outputs (the final pool unused)."""
        feats, i = [], 0
        for si, stage in enumerate(VGG16_STAGES):
            if si:
                x = self.features[i](x)  # the pool closing the last stage
                i += 1
            for _ in stage:
                x = self.features[i + 1](self.features[i](x))
                i += 2
            feats.append(x)
        return feats

    def forward(self, x: torch.Tensor) -> list:
        """x [N, H, W, 3] -> the 5 stage outputs, NCHW."""
        return self.stages(x.permute(0, 3, 1, 2))


class _Lin(nn.Module):
    """LPIPS's NetLinLayer: dropout, then a 1x1 conv to one channel."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(channels, 1, 1, bias=False))
        nn.init.ones_(self.model[1].weight)


class LPIPS(VGG16Features):
    """x, y [N, H, W, 3] in [-1, 1] -> [N] LPIPS-VGG distances, fp32."""

    def __init__(self):
        super().__init__()
        for i, stage in enumerate(VGG16_STAGES):
            setattr(self, f"lin{i}", _Lin(stage[-1]))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        shift = torch.tensor(_SHIFT, device=x.device).view(1, 3, 1, 1)
        scale = torch.tensor(_SCALE, device=x.device).view(1, 3, 1, 1)
        norm_in = lambda v: (v.float().permute(0, 3, 1, 2) - shift) / scale
        total = 0.0
        for i, (a, b) in enumerate(zip(self.stages(norm_in(x)),
                                       self.stages(norm_in(y)))):
            a = a / torch.sqrt((a * a).sum(1, keepdim=True) + 1e-10)
            b = b / torch.sqrt((b * b).sum(1, keepdim=True) + 1e-10)
            w = getattr(self, f"lin{i}").model[1].weight.abs()  # [1, C, 1, 1]
            total = total + ((a - b) ** 2 * w).sum(1).mean(dim=(1, 2))
        return total
