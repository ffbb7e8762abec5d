"""Video frames for the caption model's finetune (rsvldm_tpu/models/vlm/
video.py, the port's own copy).

Sampling: a frame folder gives uniform frames at an assumed 2 fps
(`sample_video_frames`); a container file is decoded with OpenCV
(`process_video`: the reference's decord sampling arithmetic, its
frame_time quirk included). cv2 is imported when a container is read, and
its absence raises. The feature stream (`video_feature_stream`): per-frame
projected tower features, 2-D pooled (average, max or bilinear at
half-pixel centres without antialias, JAX's interpolation tables), with
the image_newline embedding placed per grid row, per frame, once or not
at all, flattened into the one stream spliced at the record's <image>.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

FRAME_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}
ASSUMED_FPS = 2.0


def sample_video_frames(frame_dir: str, num_frames: int = 10
                        ) -> Tuple[List, float, str]:
    """`num_frames` uniform frames of a sorted frame folder: (PIL frames,
    the video's seconds, the frames' times as '0.00s,0.50s,...')."""
    from PIL import Image
    files = sorted(p for p in Path(frame_dir).iterdir()
                   if p.suffix.lower() in FRAME_EXTS)
    if not files:
        raise FileNotFoundError(f"no frames under {frame_dir}")
    total = len(files)
    idx = np.linspace(0, total - 1, min(num_frames, total)).astype(int)
    frames = [Image.open(files[i]).convert("RGB") for i in idx]
    frame_time = ",".join(f"{i / ASSUMED_FPS:.2f}s" for i in idx)
    return frames, total / ASSUMED_FPS, frame_time


def process_video(video_file: str, video_fps: int = 1,
                  frames_upbound: int = 0, force_sample: bool = False
                  ) -> Tuple[np.ndarray, float, str, int]:
    """Decode a container and sample frames: (uint8 RGB [N, H, W, 3], the
    video's seconds, the frame-time string, N). Every round(fps /
    video_fps)-th frame, times in sampling periods; past frames_upbound
    (or with force_sample) frames_upbound uniform frames, times in
    seconds."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "container video decode needs OpenCV (cv2); frame folders "
            "(a path holding shareVideoGPTV) work without it") from e
    cap = cv2.VideoCapture(str(video_file))
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {video_file}")
    try:
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        fps = cap.get(cv2.CAP_PROP_FPS) or ASSUMED_FPS
        if total <= 0:
            raise ValueError(f"container reports no frames: {video_file}")
        video_time = total / fps
        step = max(1, round(fps / video_fps))
        frame_idx = list(range(0, total, step))
        frame_time = [i / step for i in frame_idx]
        if frames_upbound > 0 and (len(frame_idx) > frames_upbound
                                   or force_sample):
            frame_idx = np.linspace(0, total - 1, frames_upbound,
                                    dtype=int).tolist()
            frame_time = [i / fps for i in frame_idx]
        wanted = set(frame_idx)
        frames = {}
        # sparse sampling seeks to each index; dense sampling decodes in
        # order (a seek re-decodes from the previous keyframe)
        if total > 8 * len(frame_idx):
            for i in frame_idx:
                cap.set(cv2.CAP_PROP_POS_FRAMES, i)
                ok, bgr = cap.read()
                if ok:
                    frames[i] = bgr[..., ::-1]
        if len(frames) < len(wanted):
            if frames:  # the seeks gave part of them: decode from the start
                cap.release()
                cap = cv2.VideoCapture(str(video_file))
                frames = {}
            pos = 0
            while pos <= frame_idx[-1]:
                if not cap.grab():
                    break
                if pos in wanted:
                    ok, bgr = cap.retrieve()
                    if ok:
                        frames[pos] = bgr[..., ::-1]  # BGR -> RGB
                pos += 1
        missing = [i for i in frame_idx if i not in frames]
        if missing:
            raise ValueError(
                f"could not decode frames {missing[:5]}... of {video_file} "
                f"(container frame count {total} may be inaccurate)")
        video = np.stack([frames[i] for i in frame_idx])
        time_str = ",".join(f"{t:.2f}s" for t in frame_time)
        return video, video_time, time_str, len(frame_idx)
    finally:
        cap.release()


def time_instruction(video_time: float, num_frames: int,
                     frame_time: str) -> str:
    """The add_time_instruction text, in the reference's words."""
    return (f"The video lasts for {video_time:.2f} seconds, and "
            f"{num_frames} frames are uniformly sampled from it. These "
            f"frames are located at {frame_time}.Please answer the "
            f"following questions related to this video.")


def clip_preprocess_frame(frame, size: int) -> np.ndarray:
    """CLIP's processor transform for a frame: bicubic resize of the short
    side to `size` (aspect kept), centre crop size x size; float32
    [size, size, 3] in [0, 1]."""
    from PIL import Image
    img = frame.convert("RGB")
    w, h = img.size
    scale = size / min(w, h)
    nw, nh = round(w * scale), round(h * scale)
    img = img.resize((nw, nh), Image.BICUBIC)
    left, top = (nw - size) // 2, (nh - size) // 2
    img = img.crop((left, top, left + size, top + size))
    return np.asarray(img, np.float32) / 255.0


def _interp_axis(n_in: int, n_out: int):
    """Bilinear sample positions along one axis (align_corners=False:
    half-pixel centres, clamped at the edges, no antialias): (low index,
    high index, fp32 fraction)."""
    x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    x0 = np.floor(x).astype(int)
    frac = (x - x0).astype(np.float32)
    return np.clip(x0, 0, n_in - 1), np.clip(x0 + 1, 0, n_in - 1), frac


def pool_2d(feats: torch.Tensor, stride: int = 2,
            mode: str = "bilinear") -> torch.Tensor:
    """[T, h*h, D] -> [T, P', D]. average / max: kernel = stride, the
    trailing remainder dropped; bilinear: resized to ceil(h / stride)."""
    t, p, d = feats.shape
    h = math.isqrt(p)
    if h * h != p:
        raise ValueError(f"video features are not square: {p} tokens")
    x = feats.reshape(t, h, h, d)
    if mode in ("average", "max"):
        h2 = h // stride
        x = x[:, :h2 * stride, :h2 * stride]
        x = x.reshape(t, h2, stride, h2, stride, d)
        x = x.mean(dim=(2, 4)) if mode == "average" else x.amax(dim=(2, 4))
        return x.reshape(t, h2 * h2, d)
    if mode == "bilinear":
        out = math.ceil(h / stride)

        def lin(arr, axis):
            lo, hi, fr = _interp_axis(arr.shape[axis], out)
            dev = arr.device
            a = arr.index_select(axis, torch.as_tensor(lo, device=dev))
            b = arr.index_select(axis, torch.as_tensor(hi, device=dev))
            shape = [1] * arr.ndim
            shape[axis] = out
            fr = torch.as_tensor(fr, device=dev).reshape(shape).to(arr.dtype)
            return a * (1 - fr) + b * fr

        x = lin(lin(x, 1), 2)
        return x.reshape(t, out * out, d)
    raise ValueError(f"Unexpected mm_spatial_pool_mode: {mode}")


def add_token_per_frame(feats: torch.Tensor,
                        newline: torch.Tensor) -> torch.Tensor:
    """The newline after each frame's tokens: [T, P, D] -> [T, P+1, D]."""
    t, _, d = feats.shape
    nl = newline.to(feats.dtype).expand(t, 1, d)
    return torch.cat([feats, nl], dim=1)


def add_token_per_grid(feats: torch.Tensor,
                       newline: torch.Tensor) -> torch.Tensor:
    """The newline after each grid row of each frame, frame-major, row-
    major: [T, h*h, D] -> [T*h*(h+1), D]."""
    t, p, d = feats.shape
    h = math.isqrt(p)
    x = feats.reshape(t, h, h, d)
    nl = newline.to(feats.dtype).expand(t, h, 1, d)
    return torch.cat([x, nl], dim=2).reshape(t * h * (h + 1), d)


def video_feature_stream(proj_feats: torch.Tensor, newline: torch.Tensor,
                         stride: int = 2, pool_mode: str = "bilinear",
                         newline_position: str = "grid",
                         patch_merge_type: str = "spatial_unpad"
                         ) -> torch.Tensor:
    """Per-frame projected features [T, P, D] and the decoder-width
    image_newline -> the flat stream [T', D] spliced at <image>."""
    x = (pool_2d(proj_feats, stride, pool_mode)
         if stride and stride > 1 else proj_feats)
    d = x.shape[-1]
    if newline_position == "grid":
        return add_token_per_grid(x, newline)
    if newline_position == "frame":
        return add_token_per_frame(x, newline).reshape(-1, d)
    if newline_position == "one_token":
        flat = x.reshape(-1, d)
        if "unpad" in patch_merge_type:
            flat = torch.cat([flat, newline.to(flat.dtype)[None]], dim=0)
        return flat
    if newline_position == "no_token":
        return x.reshape(-1, d)
    raise ValueError(f"Unexpected mm_newline_position: {newline_position}")
