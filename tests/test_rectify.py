import cv2
import numpy as np
import pytest

from i3dr_stereo_tpu.core.camera import CameraModel
from i3dr_stereo_tpu.ops.rectify import (
    inverse_rectify_map_xy,
    make_rectify_map,
    remap,
)


def _checker(h, w):
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    img = cv2.GaussianBlur(img, (5, 5), 1.2)
    return img


def test_identity_map_is_identity():
    cam = CameraModel.ideal(64, 48, 100.0)
    img = _checker(48, 64)
    rmap = make_rectify_map(cam, interpolation="cubic")
    out = np.asarray(remap(img, rmap))
    np.testing.assert_allclose(out, img, atol=1e-3)


def test_pure_shift_map():
    cam = CameraModel.ideal(64, 48, 100.0)
    img = _checker(48, 64)
    mx, my = np.meshgrid(np.arange(64, dtype=np.float64),
                         np.arange(48, dtype=np.float64))
    rmap = make_rectify_map(cam, interpolation="linear", map_xy=(mx - 3.0, my))
    out = np.asarray(remap(img, rmap))
    np.testing.assert_allclose(out[:, 5:], img[:, 2:-3], atol=1e-3)


def test_subpixel_shift_linear():
    cam = CameraModel.ideal(64, 48, 100.0)
    img = _checker(48, 64)
    mx, my = np.meshgrid(np.arange(64, dtype=np.float64),
                         np.arange(48, dtype=np.float64))
    rmap = make_rectify_map(cam, interpolation="linear", map_xy=(mx - 0.5, my))
    out = np.asarray(remap(img, rmap))
    expected = 0.5 * (img[:, 1:-1] + img[:, :-2])
    np.testing.assert_allclose(out[:, 2:-1], expected[:, 1:], atol=1e-3)


def _distorted_cam():
    K = np.array([[300.0, 0, 160.0], [0, 300.0, 120.0], [0, 0, 1]])
    D = np.array([-0.25, 0.08, 0.001, -0.001, 0.0])
    R = cv2.Rodrigues(np.array([0.002, -0.003, 0.001]))[0]
    P = np.array([[295.0, 0, 158.0, 0], [0, 295.0, 121.0, 0], [0, 0, 1, 0]])
    return CameraModel(320, 240, K, D, R, P)


def test_inverse_map_matches_opencv():
    cam = _distorted_cam()
    mx, my = inverse_rectify_map_xy(cam)
    cv_mx, cv_my = cv2.initUndistortRectifyMap(
        cam.K, cam.D, cam.R, cam.P, (320, 240), cv2.CV_32FC1)
    np.testing.assert_allclose(mx, cv_mx, atol=2e-3)
    np.testing.assert_allclose(my, cv_my, atol=2e-3)


def test_full_rectify_matches_opencv_remap():
    cam = _distorted_cam()
    img = _checker(240, 320)
    rmap = make_rectify_map(cam, interpolation="cubic")
    ours = np.asarray(remap(img, rmap))
    cv_mx, cv_my = cv2.initUndistortRectifyMap(
        cam.K, cam.D, cam.R, cam.P, (320, 240), cv2.CV_32FC1)
    theirs = cv2.remap(img, cv_mx, cv_my, cv2.INTER_CUBIC)
    # interior only: border handling differs (replicate vs constant)
    diff = np.abs(ours - theirs)[8:-8, 8:-8]
    assert np.median(diff) < 0.05
    assert diff.mean() < 0.2


def test_batched_remap():
    cam = CameraModel.ideal(32, 24, 50.0)
    imgs = np.stack([_checker(24, 32) for _ in range(3)])
    rmap = make_rectify_map(cam)
    out = np.asarray(remap(imgs, rmap))
    assert out.shape == (3, 24, 32)
    np.testing.assert_allclose(out, imgs, atol=1e-3)


@pytest.mark.parametrize("interp", ["cubic", "linear"])
def test_remap_batch_matches_single_frames(interp):
    """A batch is remapped frame by frame: each output equals the
    single-frame remap, and scaling an input scales its output."""
    cam = _distorted_cam()
    img = _checker(240, 320)
    m = make_rectify_map(cam, interpolation=interp)
    out_1 = np.asarray(remap(img, m))
    out_b = np.asarray(remap(np.stack([img, img * 0.5]), m))
    np.testing.assert_array_equal(out_b[0], out_1)
    np.testing.assert_allclose(out_b[1], 0.5 * out_1, atol=1e-3)


@pytest.mark.parametrize("interp", ["cubic", "linear"])
def test_remap_uint8_equals_float(interp):
    """uint8 sources are converted exactly, so they remap to the same
    values as their float32 copy."""
    cam = _distorted_cam()
    img = np.clip(_checker(240, 320), 0, 255).astype(np.uint8)
    m = make_rectify_map(cam, interpolation=interp)
    out_u8 = np.asarray(remap(img, m))
    out_f32 = np.asarray(remap(img.astype(np.float32), m))
    np.testing.assert_array_equal(out_u8, out_f32)


def test_remap_random_warp_matches_numpy_bilinear():
    """A non-smooth map (the generic-warp use of remap) gives plain
    bilinear interpolation with edge-replicated borders."""
    H, W = 30, 40
    cam = CameraModel.ideal(W, H, 100.0)
    rng = np.random.default_rng(0)
    mx = rng.uniform(0, W - 1, (H, W))
    my = rng.uniform(0, H - 1, (H, W))
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    m = make_rectify_map(cam, interpolation="linear", map_xy=(mx, my))
    out = np.asarray(remap(img, m))
    x0 = np.floor(mx).astype(int)
    y0 = np.floor(my).astype(int)
    fx, fy = mx - x0, my - y0
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    ref = ((1 - fy) * ((1 - fx) * img[y0, x0] + fx * img[y0, x1])
           + fy * ((1 - fx) * img[y1, x0] + fx * img[y1, x1]))
    np.testing.assert_allclose(out, ref, atol=1e-2)
