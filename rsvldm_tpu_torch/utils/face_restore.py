"""FFHQ-style face restoration helper: detect, align, restore, paste back
(rsvldm_tpu/utils/face_restore.py; the reference's
utils/face_restoration_helper.py, which its inference never imports).

Detection is pluggable: pass `detector(img_bgr) -> bboxes [N, 15]` (the
facexlib layout x0, y0, x1, y1, score, then five landmark points) or feed
five-point landmarks with `add_landmarks`. `use_parse` (facexlib's
parsenet) is refused. The similarity fit (Umeyama, what
cv2.estimateAffinePartial2D gives on clean points) and the affine
inverse are float64 host math on five points. The image work (the
affine warp, erosion, Gaussian blur, the linear resize and the soft-mask
paste) runs in fp32 torch ops on the helper's device, the card unless
device="cpu"; the functions below also take a numpy array (computed on
the CPU, returned as numpy) or a tensor (computed on its device).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.image import resize_linear

# the 5 landmarks of FFHQ faces at 512 x 512
FFHQ_TEMPLATE_512 = np.array(
    [[192.98138, 239.94708], [318.90277, 240.1936], [256.63416, 314.01935],
     [201.26117, 371.41043], [313.08905, 371.15118]])
TEMPLATE_3POINTS = np.array([[192, 240], [319, 240], [257, 371]])
# dlib's template at 1024
DLIB_TEMPLATE_1024 = np.array(
    [[686.77227723, 488.62376238], [586.77227723, 493.59405941],
     [337.91089109, 488.38613861], [437.95049505, 493.51485149],
     [513.58415842, 678.5049505]])


def estimate_similarity_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity (Umeyama) mapping src -> dst points
    ([N, 2] each): the 2x3 affine matrix."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)
    u, s, vt = np.linalg.svd(cov)
    d = np.ones(2)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        d[1] = -1
    r = u @ np.diag(d) @ vt
    scale = (s * d).sum() / ((sc ** 2).sum() / len(src))
    m = np.zeros((2, 3))
    m[:, :2] = scale * r
    m[:, 2] = mu_d - scale * (r @ mu_s)
    return m


def invert_affine(m: np.ndarray) -> np.ndarray:
    """The inverse of a 2x3 affine matrix (cv2.invertAffineTransform)."""
    a = np.asarray(m, np.float64)
    inv_lin = np.linalg.inv(a[:, :2])
    out = np.zeros((2, 3))
    out[:, :2] = inv_lin
    out[:, 2] = -inv_lin @ a[:, 2]
    return out


def _image(img):
    """(fp32 tensor [H, W, C], whether it came as numpy, whether it had no
    channel axis)."""
    was_np = not isinstance(img, torch.Tensor)
    x = torch.from_numpy(np.array(img, np.float32)) if was_np else img.float()
    flat = x.dim() == 2
    return (x[..., None] if flat else x), was_np, flat


def _out(x: torch.Tensor, was_np: bool, flat: bool):
    x = x[..., 0] if flat else x
    return x.cpu().numpy() if was_np else x


def warp_affine(img, m: np.ndarray, dsize: tuple[int, int], border_value=0.0):
    """cv2.warpAffine, bilinear with a constant border: dst(x) =
    src(M^-1 x), M the 2x3 src -> dst affine, dsize = (w, h). The four
    taps are gathered at the floor of the source position; a tap outside
    the image reads `border_value` (per channel or one number)."""
    x, was_np, flat = _image(img)
    h, w, c = x.shape
    out_w, out_h = dsize
    minv = [float(v) for v in invert_affine(m).astype(np.float32).reshape(-1)]
    bv = torch.from_numpy(np.array(np.broadcast_to(
        np.asarray(border_value, np.float32), (c,)))).to(x.device)
    gy, gx = torch.meshgrid(torch.arange(out_h, dtype=torch.float32, device=x.device),
                            torch.arange(out_w, dtype=torch.float32, device=x.device),
                            indexing="ij")
    sx = minv[0] * gx + minv[1] * gy + minv[2]
    sy = minv[3] * gx + minv[4] * gy + minv[5]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()

    def tap(yi, xi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = x[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return torch.where(inside[..., None], v, bv)

    out = (tap(y0i, x0i) * (1 - fx) * (1 - fy) + tap(y0i, x0i + 1) * fx * (1 - fy)
           + tap(y0i + 1, x0i) * (1 - fx) * fy + tap(y0i + 1, x0i + 1) * fx * fy)
    return _out(out, was_np, flat)


def erode(mask, ksize: int):
    """cv2.erode(mask, ones(ksize, ksize)) of a 2D float mask: the minimum
    over each window, the border padded with +inf so it shrinks nothing."""
    x, was_np, _ = _image(mask)
    if ksize <= 1:
        return _out(x, was_np, True)
    k = int(ksize)
    p0, p1 = k // 2, k - 1 - k // 2
    neg = F.pad(-x[..., 0][None, None], (p0, p1, p0, p1), value=-float("inf"))
    return _out(-F.max_pool2d(neg, k, stride=1)[0, 0][..., None], was_np, True)


_CV2_SMALL_GAUSSIAN = {  # getGaussianKernel's fixed tables (sigma <= 0, k <= 7)
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}


def _gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    if sigma <= 0 and ksize in _CV2_SMALL_GAUSSIAN:
        return np.asarray(_CV2_SMALL_GAUSSIAN[ksize], np.float32)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8  # cv2's default
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img, ksize: int, sigma: float = 0.0):
    """cv2.GaussianBlur: separable (rows of H first, then W), reflect-101
    border."""
    x, was_np, flat = _image(img)
    if ksize <= 1:
        return _out(x, was_np, flat)
    k, p, c = int(ksize), int(ksize) // 2, x.shape[-1]
    kern = torch.from_numpy(_gaussian_kernel1d(k, float(sigma))).to(x.device)
    y = F.pad(x.permute(2, 0, 1)[None], (p, p, p, p), mode="reflect")
    y = F.conv2d(y, kern.view(1, 1, k, 1).repeat(c, 1, 1, 1), groups=c)
    y = F.conv2d(y, kern.view(1, 1, 1, k).repeat(c, 1, 1, 1), groups=c)
    return _out(y[0].permute(1, 2, 0), was_np, flat)


def _resize_linear(img, w: int, h: int):
    """jax.image.resize(img, (h, w, ...), "linear"), antialiased when
    shrinking (ops/image.py's `resize_linear`)."""
    x, was_np, flat = _image(img)
    return _out(resize_linear(x, (h, w), dims=(0, 1)), was_np, flat)


def get_largest_face(det_faces, h, w):
    """The face of the largest clipped box: ([face], index)."""
    def loc(val, length):
        return int(max(min(val, length), 0))
    areas = [(loc(f[2], w) - loc(f[0], w)) * (loc(f[3], h) - loc(f[1], h))
             for f in det_faces]
    idx = int(np.argmax(areas))
    return [det_faces[idx]], idx


def get_center_face(det_faces, h=0, w=0, center=None):
    """The face whose box centre is nearest the image centre (or
    `center`): ([face], index)."""
    center = np.array([w / 2, h / 2]) if center is None else np.array(center)
    dists = [np.linalg.norm(np.array([(f[0] + f[2]) / 2, (f[1] + f[3]) / 2])
                            - center) for f in det_faces]
    idx = int(np.argmin(dists))
    return [det_faces[idx]], idx


@dataclass
class FaceRestoreHelper:
    """Detect (or take landmarks), align each face to the template, take the
    restored faces, paste them back into the upsampled image.

    detector: optional callable img_bgr [H, W, 3] -> np.ndarray [N, 15];
    without one, landmarks come through `add_landmarks`. device: where the
    image work runs (the card unless "cpu"); the images it keeps are
    numpy, as the reference's are."""

    upscale_factor: int
    face_size: int = 512
    crop_ratio: tuple[float, float] = (1, 1)
    template_3points: bool = False
    detector: object = None
    use_parse: bool = False
    device: Any = None

    all_landmarks_5: list = field(default_factory=list)
    det_faces: list = field(default_factory=list)
    affine_matrices: list = field(default_factory=list)
    inverse_affine_matrices: list = field(default_factory=list)
    cropped_faces: list = field(default_factory=list)
    restored_faces: list = field(default_factory=list)

    def __post_init__(self):
        self.upscale_factor = int(self.upscale_factor)
        if self.crop_ratio[0] < 1 or self.crop_ratio[1] < 1:
            raise ValueError("crop ratio only supports >= 1")
        if self.use_parse:
            raise NotImplementedError(
                "use_parse needs facexlib's parsenet, an external model not "
                "available here; the square soft mask path is implemented")
        self.device = resolve_device(self.device)
        fs = self.face_size
        self.face_size_wh = (int(fs * self.crop_ratio[1]),
                             int(fs * self.crop_ratio[0]))
        tmpl = (TEMPLATE_3POINTS if self.template_3points
                else FFHQ_TEMPLATE_512).astype(np.float64)
        tmpl = tmpl * (fs / 512.0)
        if self.crop_ratio[0] > 1:
            tmpl[:, 1] += fs * (self.crop_ratio[0] - 1) / 2
        if self.crop_ratio[1] > 1:
            tmpl[:, 0] += fs * (self.crop_ratio[1] - 1) / 2
        self.face_template = tmpl
        self.input_img = None

    def _on(self, fn, img, *args, **kw) -> np.ndarray:
        """fn on img moved to the helper's device; the result as numpy."""
        t = torch.from_numpy(np.array(img, np.float32)).to(self.device)
        return fn(t, *args, **kw).cpu().numpy()

    # -- input ------------------------------------------------------------
    def read_image(self, img: np.ndarray):
        """img: BGR uint8 / uint16 HWC (or gray, or BGRA) -> fp32 BGR,
        upsampled so its short side is at least 512."""
        img = np.asarray(img)
        if img.dtype == np.uint16 or img.max() > 256:
            img = img.astype(np.float32) / 65535 * 255
        else:
            img = img.astype(np.float32)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=2)
        elif img.shape[2] == 4:
            img = img[:, :, :3]
        self.input_img = img
        if min(img.shape[:2]) < 512:
            f = 512.0 / min(img.shape[:2])
            h, w = img.shape[:2]
            self.input_img = self._on(_resize_linear, img, int(w * f), int(h * f))

    # -- detection --------------------------------------------------------
    def get_face_landmarks_5(self, only_keep_largest=False,
                             only_center_face=False, resize=None,
                             eye_dist_threshold=None) -> int:
        if self.detector is None:
            raise RuntimeError("no detector plugged in: pass detector= or "
                               "use add_landmarks()")
        if resize is None:
            scale, input_img = 1.0, self.input_img
        else:
            h, w = self.input_img.shape[:2]
            scale = max(1.0, resize / min(h, w))
            input_img = self._on(_resize_linear, self.input_img,
                                 int(w * scale), int(h * scale))
        bboxes = self.detector(input_img)
        if bboxes is None or len(bboxes) == 0:
            return 0
        bboxes = np.asarray(bboxes, np.float64) / scale
        for bbox in bboxes:
            eye_dist = np.linalg.norm([bbox[6] - bbox[8], bbox[7] - bbox[9]])
            if eye_dist_threshold is not None and eye_dist < eye_dist_threshold:
                continue
            end = 11 if self.template_3points else 15
            self.all_landmarks_5.append(
                np.array([[bbox[i], bbox[i + 1]] for i in range(5, end, 2)]))
            self.det_faces.append(bbox[0:5])
        if not self.det_faces:
            return 0
        h, w = self.input_img.shape[:2]
        if only_keep_largest:
            self.det_faces, idx = get_largest_face(self.det_faces, h, w)
            self.all_landmarks_5 = [self.all_landmarks_5[idx]]
        elif only_center_face:
            self.det_faces, idx = get_center_face(self.det_faces, h, w)
            self.all_landmarks_5 = [self.all_landmarks_5[idx]]
        return len(self.all_landmarks_5)

    def add_landmarks(self, landmarks_5: np.ndarray):
        """One face's 5-point landmarks [5, 2], without a detector."""
        self.all_landmarks_5.append(np.asarray(landmarks_5, np.float64))

    # -- align ------------------------------------------------------------
    def align_warp_face(self, border_mode="constant"):
        if border_mode != "constant":
            raise ValueError(f"border_mode {border_mode!r}: only 'constant'")
        for lm in self.all_landmarks_5:
            m = estimate_similarity_transform(lm, self.face_template)
            self.affine_matrices.append(m)
            cropped = self._on(warp_affine, self.input_img, m, self.face_size_wh,
                               border_value=(135.0, 133.0, 132.0))
            self.cropped_faces.append(np.clip(cropped, 0, 255))

    def get_inverse_affine(self):
        for m in self.affine_matrices:
            self.inverse_affine_matrices.append(
                invert_affine(m) * self.upscale_factor)

    def add_restored_face(self, restored_face, input_face=None):
        self.restored_faces.append(np.asarray(restored_face, np.float32))

    # -- paste ------------------------------------------------------------
    def paste_faces_to_input_image(self, upsample_img=None) -> np.ndarray:
        """Each restored face warped back and blended into the upsampled
        image through an eroded, blurred mask; uint8. A gray background is
        blended in 3 channels, an alpha plane re-attached."""
        h, w = self.input_img.shape[:2]
        h_up, w_up = int(h * self.upscale_factor), int(w * self.upscale_factor)
        src = self.input_img if upsample_img is None else upsample_img
        up = torch.from_numpy(np.array(src, np.float32)).to(self.device)
        up = resize_linear(up, (h_up, w_up), dims=(0, 1))
        alpha = None
        if up.dim() == 2:
            up = up[:, :, None].repeat(1, 1, 3)
        elif up.shape[2] == 4:
            alpha, up = up[:, :, 3:], up[:, :, :3]
        if len(self.restored_faces) != len(self.inverse_affine_matrices):
            raise ValueError("one restored face per inverse affine matrix")
        for restored, inv in zip(self.restored_faces,
                                 self.inverse_affine_matrices):
            inv = inv.copy()
            if self.upscale_factor > 1:
                # half-pixel offset for a more precise back alignment
                inv[:, 2] += 0.5 * self.upscale_factor
            face = torch.from_numpy(np.array(restored, np.float32)).to(self.device)
            inv_restored = warp_affine(face, inv, (w_up, h_up))
            mask = torch.ones(self.face_size_wh[::-1], device=self.device)
            inv_mask = warp_affine(mask, inv, (w_up, h_up))
            # remove the warp's black border
            inv_mask_ero = erode(inv_mask, int(2 * self.upscale_factor))
            pasted_face = inv_mask_ero[:, :, None] * inv_restored
            # the fusion edge's width scales with the face's area
            w_edge = int(float(inv_mask_ero.sum()) ** 0.5) // 20
            inv_mask_center = erode(inv_mask_ero, max(1, w_edge * 2))
            soft = gaussian_blur(inv_mask_center, max(1, w_edge * 2 + 1))[:, :, None]
            up = soft * pasted_face + (1 - soft) * up
        if alpha is not None:
            up = torch.cat([up, alpha], dim=2)
        return up.clamp(0, 255).cpu().numpy().astype(np.uint8)

    def clean_all(self):
        self.all_landmarks_5 = []
        self.det_faces = []
        self.affine_matrices = []
        self.inverse_affine_matrices = []
        self.cropped_faces = []
        self.restored_faces = []
