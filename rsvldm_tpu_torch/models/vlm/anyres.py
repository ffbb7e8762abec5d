"""AnyRes image preprocessing and feature reassembly, host-side NumPy/PIL
(rsvldm_tpu/models/vlm/anyres.py; the reference's llava/mm_utils.py and the
spatial_unpad branch of llava_arch.py).

The 'anyres_max_N' variant (`max_num_patches`) downscales the unpadded
feature map with the triangle filter of JAX's
`jax.image.resize(method="linear")`, which widens the filter when it
shrinks (antialias): torch's bilinear interpolation with antialias=True.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

# llama3-llava-next-8b grid pinpoints (2x2 grid family at 336)
DEFAULT_GRID_PINPOINTS = [(336, 672), (672, 336), (672, 672),
                          (1008, 336), (336, 1008)]


def grid_pinpoints_for(patch_size: int):
    """The default pinpoints rescaled to another tower size."""
    s = patch_size / 336
    return [(int(w * s), int(h * s)) for w, h in DEFAULT_GRID_PINPOINTS]


def select_best_resolution(original_size, possible_resolutions):
    """The (w, h) with the largest effective resolution, then the least
    wasted area (mm_utils.py:121-151)."""
    ow, oh = original_size
    best_fit = None
    max_effective = 0
    min_wasted = float("inf")
    for (w, h) in possible_resolutions:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        effective = min(dw * dh, ow * oh)
        wasted = w * h - effective
        if effective > max_effective or (effective == max_effective
                                         and wasted < min_wasted):
            max_effective = effective
            min_wasted = wasted
            best_fit = (w, h)
    return best_fit


def resize_and_pad_image(image, target):
    """Aspect-preserving bicubic resize, then centre-pad to (w, h)."""
    ow, oh = image.size
    tw, th = target
    scale_w, scale_h = tw / ow, th / oh
    if scale_w < scale_h:
        nw, nh = tw, min(math.ceil(oh * scale_w), th)
    else:
        nh, nw = th, min(math.ceil(ow * scale_h), tw)
    resized = image.resize((nw, nh), Image.BICUBIC)
    out = Image.new("RGB", (tw, th), (0, 0, 0))
    out.paste(resized, ((tw - nw) // 2, (th - nh) // 2))
    return out


def divide_to_patches(image, patch_size):
    """Row-major patch_size x patch_size crops."""
    w, h = image.size
    return [image.crop((j, i, j + patch_size, i + patch_size))
            for i in range(0, h, patch_size) for j in range(0, w, patch_size)]


def get_anyres_image_grid_shape(image_size, grid_pinpoints, patch_size):
    """(n_patch_w, n_patch_h) of the chosen resolution."""
    w, h = select_best_resolution(image_size, grid_pinpoints)
    return w // patch_size, h // patch_size


def process_anyres_image(image, patch_size: int = 336,
                         grid_pinpoints=DEFAULT_GRID_PINPOINTS) -> np.ndarray:
    """PIL -> [1 + n_patches, S, S, 3] float32 in [0, 1]: the square-resized
    base image, then the grid tiles."""
    best = select_best_resolution(image.size, grid_pinpoints)
    patches = divide_to_patches(resize_and_pad_image(image, best), patch_size)
    base = image.resize((patch_size, patch_size), Image.BICUBIC)
    return np.stack([np.asarray(p.convert("RGB"), np.float32) / 255.0
                     for p in [base] + patches])


def unpad_feature(feature: np.ndarray, original_size) -> np.ndarray:
    """Remove the letterbox padding from a [H, W, C] feature map."""
    ow, oh = original_size
    h, w = feature.shape[:2]
    if ow / oh > w / h:
        nh = int(oh * (w / ow))
        pad = (h - nh) // 2
        return feature[pad:h - pad, :, :]
    nw = int(ow * (h / oh))
    pad = (w - nw) // 2
    return feature[:, pad:w - pad, :]


def assemble_spatial_unpad(features: np.ndarray, image_size,
                           image_newline: np.ndarray,
                           grid_pinpoints=DEFAULT_GRID_PINPOINTS,
                           patch_size: int = 336,
                           max_num_patches: int | None = None) -> np.ndarray:
    """[1 + n, T, C] projected features -> [tokens, C]: the T base tokens,
    then the unpadded tile grid row by row, each row closed by the
    image_newline column. With max_num_patches N, an unpadded map of more
    than 1.1^2 N patch areas is first downscaled by sqrt(h w / (N side^2))
    (llava_arch.py:385-397)."""
    side = int(math.sqrt(features.shape[1]))
    c = features.shape[-1]
    npw, nph = get_anyres_image_grid_shape(image_size, grid_pinpoints, patch_size)
    grid = features[1:].reshape(nph, npw, side, side, c)
    grid = grid.transpose(0, 2, 1, 3, 4).reshape(nph * side, npw * side, c)
    grid = unpad_feature(grid, image_size)
    if max_num_patches is not None:
        h, w = grid.shape[:2]
        times = math.sqrt(h * w / (max_num_patches * side ** 2))
        if times > 1.1:
            nh, nw = int(h // times), int(w // times)
            t = torch.from_numpy(np.ascontiguousarray(grid, np.float32))
            t = F.interpolate(t.permute(2, 0, 1)[None], size=(nh, nw),
                              mode="bilinear", align_corners=False,
                              antialias=True)
            grid = t[0].permute(1, 2, 0).numpy()
    newline = np.broadcast_to(image_newline, (grid.shape[0], 1, c))
    grid = np.concatenate([grid, newline], axis=1)
    return np.concatenate([features[0], grid.reshape(-1, c)], axis=0)


def expand2square(pil_img, background_color):
    """Pad a PIL image to a centred square with the given fill: the "pad"
    image_aspect_ratio mode (rsvldm_tpu/models/vlm/anyres.py:162)."""
    width, height = pil_img.size
    if width == height:
        return pil_img
    side = max(width, height)
    result = Image.new(pil_img.mode, (side, side), background_color)
    result.paste(pil_img, ((side - width) // 2, (side - height) // 2))
    return result
