"""Rectification: undistort+rectify maps computed once, remap as a fused gather.

The reference recomputes ``cv::initUndistortRectifyMap`` **every frame**
inside the image callback (generate_disparity.cpp:370-386 — a known
inefficiency) and again in the standalone node (rectify.cpp:111-127),
then does a ``cv::remap`` with INTER_CUBIC.

Design here: the map depends only on the calibration, so the
inverse map (plumb-bob distortion through the rectifying rotation) and
the separable bicubic interpolation weights are precomputed **once** on
the host in float64, shipped to the device, and every frame is a single
jitted weighted gather — XLA fuses the 16 taps into one pass over
device memory.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from i3dr_stereo_tpu.core.camera import CameraModel


def _cubic_weights(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution weights for the 4 taps at offsets
    {-1, 0, 1, 2} from the floor sample; a=-0.75 matches cv INTER_CUBIC."""
    t = t[..., None]
    x = np.abs(t - np.array([-1.0, 0.0, 1.0, 2.0]))  # distance to each tap
    w = np.where(
        x <= 1.0,
        (a + 2.0) * x**3 - (a + 3.0) * x**2 + 1.0,
        np.where(x < 2.0, a * (x**3 - 5.0 * x**2 + 8.0 * x - 4.0), 0.0),
    )
    return w  # (..., 4)


def _linear_weights(t: np.ndarray) -> np.ndarray:
    t = t[..., None]
    off = np.array([0.0, 1.0])
    return np.clip(1.0 - np.abs(t - off), 0.0, 1.0)  # (..., 2)


def inverse_rectify_map_xy(cam: CameraModel) -> tuple[np.ndarray, np.ndarray]:
    """For each rectified pixel, the source coordinate in the raw image.

    Same math as cv::initUndistortRectifyMap: unproject through the
    rectified projection P, rotate by R^-1, apply plumb-bob distortion,
    project through raw K. Host-side float64, once per calibration.
    """
    H, W = cam.height, cam.width
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    x = (u - cam.cx) / cam.fx
    y = (v - cam.cy) / cam.fy
    # rotate into the raw camera frame
    Rinv = np.linalg.inv(cam.R)
    X = Rinv[0, 0] * x + Rinv[0, 1] * y + Rinv[0, 2]
    Y = Rinv[1, 0] * x + Rinv[1, 1] * y + Rinv[1, 2]
    Z = Rinv[2, 0] * x + Rinv[2, 1] * y + Rinv[2, 2]
    xp = X / Z
    yp = Y / Z
    # plumb_bob distortion (k1 k2 p1 p2 k3)
    D = np.zeros(5)
    D[: cam.D.size] = cam.D[:5]
    k1, k2, p1, p2, k3 = D
    r2 = xp * xp + yp * yp
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = xp * radial + 2.0 * p1 * xp * yp + p2 * (r2 + 2.0 * xp * xp)
    yd = yp * radial + p1 * (r2 + 2.0 * yp * yp) + 2.0 * p2 * xp * yp
    map_x = cam.K[0, 0] * xd + cam.K[0, 2]
    map_y = cam.K[1, 1] * yd + cam.K[1, 2]
    return map_x, map_y


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RectifyMap:
    """Precomputed remap: flat gather indices + separable tap weights.

    ``flat_idx[h, w]`` indexes the top-left tap of the (T x T) stencil in
    the flattened padded source image; ``wx``/``wy`` are the T horizontal
    / vertical weights (T=4 cubic, T=2 linear).
    """

    flat_idx: jax.Array   # (H, W) int32 into padded flat image
    wx: jax.Array         # (H, W, T) float32
    wy: jax.Array         # (H, W, T) float32
    src_h: int = dataclasses.field(default=0, metadata=dict(static=True))
    src_w: int = dataclasses.field(default=0, metadata=dict(static=True))
    pad: int = dataclasses.field(default=0, metadata=dict(static=True))
    taps: int = dataclasses.field(default=2, metadata=dict(static=True))

    @property
    def padded_w(self) -> int:
        return self.src_w + 2 * self.pad


def make_rectify_map(cam: CameraModel, *, interpolation: str = "cubic",
                     map_xy: tuple[np.ndarray, np.ndarray] | None = None
                     ) -> RectifyMap:
    """Build the device-side remap structure (host, once).

    ``map_xy`` overrides the calibration-derived inverse map — used for
    generic remap applications (e.g. unit tests, custom warps).
    """
    if map_xy is None:
        map_x, map_y = inverse_rectify_map_xy(cam)
    else:
        map_x, map_y = map_xy
    H, W = map_x.shape
    if interpolation == "cubic":
        taps, pad = 4, 2  # stencil offsets -1..2 around floor => pad 2
        x0 = np.floor(map_x)
        y0 = np.floor(map_y)
        wx = _cubic_weights(map_x - x0)
        wy = _cubic_weights(map_y - y0)
        base_x = x0 - 1.0
        base_y = y0 - 1.0
    elif interpolation == "linear":
        taps, pad = 2, 1
        base_x = np.floor(map_x)
        base_y = np.floor(map_y)
        wx = _linear_weights(map_x - base_x)
        wy = _linear_weights(map_y - base_y)
    else:
        raise ValueError(f"unknown interpolation {interpolation!r}")

    # out-of-range source coords: clamp the stencil inside the padded image
    # (padding is edge-replicated, matching cv BORDER_REPLICATE-ish edges;
    # fully outside pixels read replicated border like cv BORDER_CONSTANT=0
    # would differ only in a <=2px frame at the border).
    src_h, src_w = cam.height, cam.width
    bx = np.clip(base_x + pad, 0, src_w + 2 * pad - taps)
    by = np.clip(base_y + pad, 0, src_h + 2 * pad - taps)
    flat = (by * (src_w + 2 * pad) + bx).astype(np.int32)
    return RectifyMap(
        flat_idx=jnp.asarray(flat),
        wx=jnp.asarray(wx, dtype=jnp.float32),
        wy=jnp.asarray(wy, dtype=jnp.float32),
        src_h=int(src_h),
        src_w=int(src_w),
        pad=pad,
        taps=taps,
    )


@jax.jit
def remap(image: jax.Array, rmap: RectifyMap) -> jax.Array:
    """Apply the precomputed map to a (H, W) or (B, H, W) image.

    16 (cubic) / 4 (linear) flat gathers with separable weights, fused
    under jit. uint8 sources are converted to float32 first, so they give
    the same values as their float32 copy.
    """
    batched = image.ndim == 3
    img = (image if batched else image[None]).astype(jnp.float32)
    p = rmap.pad
    padded = jnp.pad(img, ((0, 0), (p, p), (p, p)), mode="edge")
    B = padded.shape[0]
    flat = padded.reshape(B, -1)
    W = rmap.padded_w

    out = jnp.zeros((B,) + rmap.flat_idx.shape, dtype=jnp.float32)
    for j in range(rmap.taps):
        row_acc = jnp.zeros_like(out)
        for i in range(rmap.taps):
            idx = (rmap.flat_idx + (j * W + i)).reshape(-1)
            tap = jnp.take(flat, idx, axis=1).reshape(out.shape)
            row_acc = row_acc + tap * rmap.wx[..., i]
        out = out + row_acc * rmap.wy[..., j]
    return out if batched else out[0]


def rectify_pair(left: jax.Array, right: jax.Array,
                 lmap: RectifyMap, rmap: RectifyMap) -> tuple[jax.Array, jax.Array]:
    return remap(left, lmap), remap(right, rmap)
