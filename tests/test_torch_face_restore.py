"""The port's face restoration helper (rsvldm_tpu_torch/utils/face_restore.py)
held against the JAX package's on the CPU, fp32: the cases of JAX's
tests/test_face_restore.py, each taken by both and compared, floats within
1e-4 (relative to the 0-255 range where the values are pixels); the
uint8 pastes within one level, at under 0.1% of the pixels (a float
difference of 1e-5 can cross a truncation step)."""

import numpy as np
import pytest
import torch

from rsvldm_tpu.utils import face_restore as J
from rsvldm_tpu_torch.utils import face_restore as T

torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")


def _rand_similarity(rng):
    th = rng.uniform(-0.6, 0.6)
    s = rng.uniform(0.5, 2.0)
    m = np.zeros((2, 3))
    m[:, :2] = s * np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    m[:, 2] = rng.uniform(-40, 40, size=2)
    return m


def _apply(m, pts):
    return pts @ m[:, :2].T + m[:, 2]


def _close_px(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def _uint8_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("case", ["clean_fit", "noisy_fit"])
def test_similarity_and_inverse_equal_jax(case):
    """JAX's two cases, with its np.allclose against cv2: landmarks mapped
    exactly (atol 1e-6), and template points against noisy landmarks
    (atol 1e-5)."""
    rng = np.random.default_rng(0 if case == "clean_fit" else 1)
    for _ in range(5 if case == "clean_fit" else 1):
        m = _rand_similarity(rng)
        if case == "clean_fit":
            src = T.FFHQ_TEMPLATE_512 + rng.normal(scale=0.5, size=(5, 2))
            dst, tol = _apply(m, src), 1e-6
        else:
            src = T.FFHQ_TEMPLATE_512
            dst, tol = _apply(m, src) + rng.normal(scale=1.5, size=(5, 2)), 1e-5
        got = T.estimate_similarity_transform(src, dst)
        np.testing.assert_allclose(got, J.estimate_similarity_transform(src, dst),
                                   atol=1e-12)
        ref = cv2.estimateAffinePartial2D(src, dst, method=cv2.LMEDS)[0]
        assert np.allclose(got, ref, atol=tol), (got, ref)
        np.testing.assert_allclose(T.invert_affine(m), J.invert_affine(m),
                                   atol=1e-12)
        np.testing.assert_allclose(T.invert_affine(m), cv2.invertAffineTransform(m),
                                   atol=1e-10)


@pytest.mark.parametrize("channels", [0, 1, 3])
def test_warp_affine_equals_jax(channels):
    rng = np.random.default_rng(3)
    shape = (64, 80) + ((channels,) if channels else ())
    img = rng.uniform(0, 255, size=shape).astype(np.float32)
    m = np.array([[0.9, -0.2, 8.0], [0.2, 0.9, -5.0]])
    border = (135.0, 133.0, 132.0)[:max(channels, 1)]
    got = T.warp_affine(img, m, (72, 60), border_value=border)
    _close_px(got, J.warp_affine(img, m, (72, 60), border_value=border))
    if channels == 3:
        ref = cv2.warpAffine(img, m, (72, 60), flags=cv2.INTER_LINEAR,
                             borderMode=cv2.BORDER_CONSTANT, borderValue=border)
        assert np.max(np.abs(got - ref)) < 0.75  # cv2's 5-bit weights
    # a tensor in, a tensor out, on its device
    t = T.warp_affine(torch.from_numpy(img), m, (72, 60), border_value=border)
    assert isinstance(t, torch.Tensor)
    np.testing.assert_array_equal(t.numpy(), got)


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
def test_erode_equals_jax(k):
    mask = (np.random.default_rng(4).uniform(size=(40, 52)) > 0.3).astype(np.float32)
    got = T.erode(mask, k)
    np.testing.assert_array_equal(got, J.erode(mask, k))
    np.testing.assert_array_equal(got, cv2.erode(mask, np.ones((k, k), np.uint8)))


@pytest.mark.parametrize("k,sigma", [(3, 0.0), (7, 0.0), (11, 0.0), (9, 2.5)])
def test_gaussian_blur_equals_jax(k, sigma):
    rng = np.random.default_rng(5)
    for shape in ((48, 40), (30, 26, 3)):
        img = rng.uniform(0, 1, size=shape).astype(np.float32)
        got = T.gaussian_blur(img, k, sigma)
        _close_px(got, J.gaussian_blur(img, k, sigma), 1e-5)
        ref = cv2.GaussianBlur(img, (k, k), sigma)
        assert np.max(np.abs(got - ref)) < 2e-4


@pytest.mark.parametrize("size", [(700, 600), (250, 300), (560, 600)])
def test_resize_linear_equals_jax(size):
    img = np.random.default_rng(6).uniform(0, 255, (560, 600, 3)).astype(np.float32)
    _close_px(T._resize_linear(img, *size), J._resize_linear(img, *size))


def test_face_selection_equals_jax():
    faces = [np.array([0, 0, 10, 10, 0.9]), np.array([20, 20, 60, 60, 0.8]),
             np.array([45, 45, 55, 55, 0.7]), np.array([-30, 80, 130, 140, 0.5])]
    for h, w in ((100, 100), (60, 200)):
        assert T.get_largest_face(faces, h, w)[1] == J.get_largest_face(faces, h, w)[1]
        assert T.get_center_face(faces, h, w)[1] == J.get_center_face(faces, h, w)[1]
    assert (T.get_center_face(faces, center=(5, 5))[1]
            == J.get_center_face(faces, center=(5, 5))[1] == 0)


def _helpers(upscale, img, lms, **kw):
    out = []
    for mod, extra in ((T, {"device": "cpu"}), (J, {})):
        h = mod.FaceRestoreHelper(upscale_factor=upscale, **kw, **extra)
        h.read_image(img.astype(np.uint8))
        h.add_landmarks(lms)
        h.align_warp_face()
        h.get_inverse_affine()
        h.add_restored_face(h.cropped_faces[0])
        out.append(h)
    return out


@pytest.mark.parametrize("upscale,crop", [(2, (1, 1)), (1, (1.5, 1.2))])
def test_helper_end_to_end_equals_jax(upscale, crop):
    rng = np.random.default_rng(6)
    img = rng.uniform(40, 200, size=(560, 600, 3)).astype(np.float32)
    m = np.array([[0.4, -0.1, 150.0], [0.1, 0.4, 120.0]])
    th, jh = _helpers(upscale, img, _apply(m, T.FFHQ_TEMPLATE_512), crop_ratio=crop)
    _close_px(th.input_img, jh.input_img)
    np.testing.assert_allclose(th.face_template, jh.face_template)
    np.testing.assert_allclose(th.affine_matrices[0], jh.affine_matrices[0])
    _close_px(th.cropped_faces[0], jh.cropped_faces[0])
    out, ref = th.paste_faces_to_input_image(), jh.paste_faces_to_input_image()
    _uint8_close(out, ref)
    h, w = th.input_img.shape[:2]
    assert out.shape == (h * upscale, w * upscale, 3)


def test_small_input_is_upsampled_as_jax():
    img = np.random.default_rng(7).integers(0, 255, (300, 420, 3), dtype=np.uint8)
    th = T.FaceRestoreHelper(upscale_factor=1, device="cpu")
    jh = J.FaceRestoreHelper(upscale_factor=1)
    th.read_image(img)
    jh.read_image(img)
    assert th.input_img.shape == jh.input_img.shape == (512, 716, 3)
    _close_px(th.input_img, jh.input_img)


def test_detector_plumbing_equals_jax():
    calls = []

    def det(img):
        calls.append(img.shape)
        big = np.r_[100, 100, 400, 400, 0.99,
                    _apply(np.eye(2, 3), T.FFHQ_TEMPLATE_512 * 0.6).ravel()]
        tiny = np.r_[0, 0, 6, 6, 0.5, [1, 1, 2, 1, 1.5, 1.5, 1, 2, 2, 2]]
        return np.stack([big, tiny])

    got = []
    for mod, extra in ((T, {"device": "cpu"}), (J, {})):
        for kw in (dict(only_keep_largest=True, eye_dist_threshold=5.0),
                   dict(only_center_face=True, resize=640), {}):
            h = mod.FaceRestoreHelper(upscale_factor=1, detector=det, **extra)
            h.read_image(np.zeros((520, 520, 3), np.uint8))
            n = h.get_face_landmarks_5(**kw)
            got.append((mod is T, n, [lm.tolist() for lm in h.all_landmarks_5]))
    half = len(got) // 2
    assert [g[1:] for g in got[:half]] == [g[1:] for g in got[half:]]
    assert calls[1] == (640, 640, 3)
    with pytest.raises(RuntimeError, match="detector"):
        T.FaceRestoreHelper(upscale_factor=1, device="cpu").get_face_landmarks_5()


def test_use_parse_rejected():
    with pytest.raises(NotImplementedError):
        T.FaceRestoreHelper(upscale_factor=1, use_parse=True, device="cpu")


def test_paste_gray_and_bgra_backgrounds_equal_jax():
    rng = np.random.default_rng(8)
    img = rng.uniform(40, 200, size=(560, 600, 3)).astype(np.float32)
    m = np.array([[0.4, -0.1, 150.0], [0.1, 0.4, 120.0]])
    th, jh = _helpers(1, img, _apply(m, T.FFHQ_TEMPLATE_512))
    h, w = th.input_img.shape[:2]
    gray = np.full((h, w), 90.0, np.float32)
    _uint8_close(th.paste_faces_to_input_image(upsample_img=gray),
                 jh.paste_faces_to_input_image(upsample_img=gray))
    bgra = np.concatenate([img, np.full((h, w, 1), 255.0, np.float32)], axis=2)
    out4 = th.paste_faces_to_input_image(upsample_img=bgra)
    _uint8_close(out4, jh.paste_faces_to_input_image(upsample_img=bgra))
    np.testing.assert_array_equal(out4[:, :, 3], 255)
