"""Frame-to-frame depth odometry — the pose source for the mapping hook.

The reference's processing graph feeds /points2 into rtabmap, whose job
is to ESTIMATE camera poses and hand them to the map builder
(launch/stereo_processing.launch:88-122). The TSDF consumer
(:mod:`i3dr_stereo_tpu.mapping.tsdf`) is pose-aware but round 4 shipped
no pose source; this module closes that loop with the classic dense
tracker that pairs naturally with a TSDF: **projective point-to-plane
ICP on depth images** (the KinectFusion tracker), formulated for XLA:

- data association is PROJECTIVE (transform the current vertex map,
  project into the previous frame, read the hit pixel) — one flat
  gather per pixel per iteration instead of a nearest-neighbour search;
  the same inside-out gather formulation as the TSDF update itself;
- the 6-DoF normal equations are plain reductions: J = [p x n; n],
  A = sum J J^T (6x6), b = -sum r J — a handful of elementwise products
  and sums, fused by XLA; the tiny 6x6 solve is negligible;
- iteration counts and pyramid levels are STATIC (lax-free Python loops
  inside one jit), so the whole multi-level tracker is a single
  compiled program per depth shape;
- the tracker runs on a downsampled depth pyramid (coarse-to-fine),
  which both convexifies the alignment and keeps the per-iteration
  gather volume small (full-res tracking is never needed for odometry);
- every matrix product asks for full float32 precision: a GPU would
  otherwise run them in TF32, and an ICP solve in TF32 is wrong.

Pose conventions match :class:`~i3dr_stereo_tpu.mapping.tsdf.TSDFVolume`:
``T_cw`` maps world -> camera; ``T_wc = inv(T_cw)`` camera -> world.
:func:`estimate_motion` returns ``T_pc`` mapping CURRENT-frame points
into the PREVIOUS camera frame, so ``T_wc_cur = T_wc_prev @ T_pc``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_HI = jax.lax.Precision.HIGHEST
_mm = partial(jnp.matmul, precision=_HI)


def _backproject(depth: jax.Array, K: jax.Array) -> jax.Array:
    """(H, W) depth -> (H, W, 3) camera-frame vertex map (0 invalid)."""
    H, W = depth.shape
    u = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    v = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    x = (u - K[0, 2]) / K[0, 0] * depth
    y = (v - K[1, 2]) / K[1, 1] * depth
    return jnp.stack([x, y, depth], axis=-1)


def _normals(verts: jax.Array, valid: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Central-difference surface normals of a vertex map (unit, camera
    frame, oriented toward the camera: n . p < 0)."""
    dx = jnp.roll(verts, -1, axis=1) - jnp.roll(verts, 1, axis=1)
    dy = jnp.roll(verts, -1, axis=0) - jnp.roll(verts, 1, axis=0)
    n = jnp.cross(dx, dy)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    ok = (norm[..., 0] > 1e-9) & valid \
        & jnp.roll(valid, 1, 0) & jnp.roll(valid, -1, 0) \
        & jnp.roll(valid, 1, 1) & jnp.roll(valid, -1, 1)
    n = n / jnp.maximum(norm, 1e-9)
    # orient toward the camera
    flip = jnp.sum(n * verts, axis=-1, keepdims=True) > 0
    n = jnp.where(flip, -n, n)
    return n, ok


def _downsample_depth(d: jax.Array) -> jax.Array:
    """2x2 mean-of-valid downsample: averaging across a depth edge
    invents phantom surfaces, so take the mean of VALID entries only.
    Two single-axis pair-sums: along x, then along y."""
    H, W = d.shape
    H2, W2 = H // 2 * 2, W // 2 * 2
    x = d[:H2, :W2]
    v = (x > 0).astype(d.dtype)
    xs = (x * v).reshape(H2, W2 // 2, 2).sum(-1)
    xs = xs.reshape(H2 // 2, 2, W2 // 2).sum(1)
    c = v.reshape(H2, W2 // 2, 2).sum(-1)
    c = c.reshape(H2 // 2, 2, W2 // 2).sum(1)
    return jnp.where(c > 0, xs / jnp.maximum(c, 1), 0.0)


def _so3_hat(w):
    wx, wy, wz = w[0], w[1], w[2]
    z = jnp.zeros(())
    return jnp.array([[z, -wz, wy], [wz, z, -wx], [-wy, wx, z]])


def _se3_exp(xi: jax.Array) -> jax.Array:
    """Exact SE(3) exponential of [omega; t] (Rodrigues) -> 4x4."""
    w, u = xi[:3], xi[3:]
    th = jnp.linalg.norm(w)
    Wh = _so3_hat(w)
    # stable small-angle forms
    a = jnp.where(th > 1e-8, jnp.sin(th) / jnp.maximum(th, 1e-12), 1.0)
    b = jnp.where(th > 1e-8,
                  (1.0 - jnp.cos(th)) / jnp.maximum(th * th, 1e-12), 0.5)
    c = jnp.where(th > 1e-8,
                  (th - jnp.sin(th)) / jnp.maximum(th ** 3, 1e-12), 1.0 / 6.0)
    eye = jnp.eye(3)
    R = eye + a * Wh + b * _mm(Wh, Wh)
    V = eye + b * Wh + c * _mm(Wh, Wh)
    T = jnp.eye(4)
    T = T.at[:3, :3].set(R)
    T = T.at[:3, 3].set(_mm(V, u))
    return T


def _icp_level(Vp, Np, okp, Vc, okc, K, T, iters: int, dist_thresh):
    """Gauss-Newton point-to-plane iterations at one pyramid level.

    Vp/Np/okp: previous-frame vertex/normal/valid maps. Vc/okc: current
    frame. T: current estimate of T_pc (cur -> prev). Returns (T, rmse,
    inlier fraction)."""
    H, W = okp.shape
    rmse = jnp.float32(0.0)
    frac = jnp.float32(0.0)
    for _ in range(iters):
        R, t = T[:3, :3], T[:3, 3]
        p = _mm(Vc, R.T) + t                           # (H, W, 3) in prev frame
        u = K[0, 0] * p[..., 0] / jnp.maximum(p[..., 2], 1e-9) + K[0, 2]
        v = K[1, 1] * p[..., 1] / jnp.maximum(p[..., 2], 1e-9) + K[1, 2]
        ui = jnp.round(u).astype(jnp.int32)
        vi = jnp.round(v).astype(jnp.int32)
        inb = (p[..., 2] > 1e-6) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        flat = jnp.clip(vi, 0, H - 1) * W + jnp.clip(ui, 0, W - 1)
        q = jnp.take(Vp.reshape(-1, 3), flat.ravel(), axis=0).reshape(H, W, 3)
        n = jnp.take(Np.reshape(-1, 3), flat.ravel(), axis=0).reshape(H, W, 3)
        hit_ok = jnp.take(okp.ravel(), flat.ravel()).reshape(H, W)

        d = p - q
        r = jnp.sum(d * n, axis=-1)                    # point-to-plane residual
        close = jnp.sum(d * d, axis=-1) < dist_thresh * dist_thresh
        w = okc & inb & hit_ok & close
        wgt = w.astype(jnp.float32)

        cx = jnp.cross(p, n)                           # J rotation block
        J = jnp.concatenate([cx, n], axis=-1)          # (H, W, 6)
        Jw = J * wgt[..., None]
        A = jnp.einsum("hwi,hwj->ij", Jw, J, precision=_HI)
        b = -jnp.einsum("hwi,hw->i", Jw, r, precision=_HI)
        A = A + 1e-6 * jnp.eye(6)                      # Levenberg damping
        xi = jnp.linalg.solve(A, b)
        T = _mm(_se3_exp(xi), T)
        nw = jnp.maximum(jnp.sum(wgt), 1.0)
        rmse = jnp.sqrt(jnp.sum(wgt * r * r) / nw)
        frac = nw / (H * W)
    return T, rmse, frac


@partial(jax.jit, static_argnames=("levels", "iters"))
def _track(depth_prev, depth_cur, K, T_init,
           levels: int = 3, iters: Tuple[int, ...] = (4, 7, 10),
           dist_thresh=0.5):
    """Coarse-to-fine projective ICP. Returns (T_pc, rmse, inlier_frac)."""
    # build depth pyramids (level 0 = input resolution)
    dps = [depth_prev]
    dcs = [depth_cur]
    for _ in range(levels - 1):
        dps.append(_downsample_depth(dps[-1]))
        dcs.append(_downsample_depth(dcs[-1]))

    T = T_init
    rmse = jnp.float32(0.0)
    frac = jnp.float32(0.0)
    for li in range(levels - 1, -1, -1):               # coarse -> fine
        s = 2.0 ** li
        Kl = jnp.array([[K[0, 0] / s, 0.0, (K[0, 2] + 0.5) / s - 0.5],
                        [0.0, K[1, 1] / s, (K[1, 2] + 0.5) / s - 0.5],
                        [0.0, 0.0, 1.0]])
        dp, dc = dps[li], dcs[li]
        vp, vc = dp > 0, dc > 0
        Vp = _backproject(dp, Kl)
        Vc = _backproject(dc, Kl)
        Np, okp = _normals(Vp, vp)
        # iters is indexed by pyramid level (0 = finest): the classic
        # coarse-to-fine budget runs MORE Gauss-Newton steps at the
        # cheap coarse levels (4x less work per step per level) and a
        # few polish steps at full resolution
        T, rmse, frac = _icp_level(Vp, Np, okp & vp, Vc, vc, Kl, T,
                                   iters[min(li, len(iters) - 1)],
                                   dist_thresh)
    return T, rmse, frac


def estimate_motion(depth_prev, depth_cur, K, *,
                    T_init: Optional[np.ndarray] = None,
                    levels: int = 3, iters: Tuple[int, ...] = (4, 7, 10),
                    dist_thresh: float = 0.5):
    """Estimate T_pc mapping current-frame points into the previous
    camera frame, by coarse-to-fine projective point-to-plane ICP.

    depth_*: (H, W) metres, 0 = invalid. Returns (T_pc 4x4 np.ndarray,
    diagnostics dict with rmse [m] and inlier fraction)."""
    Ti = jnp.asarray(np.eye(4, dtype=np.float32) if T_init is None
                     else T_init, jnp.float32)
    T, rmse, frac = _track(jnp.asarray(depth_prev, jnp.float32),
                           jnp.asarray(depth_cur, jnp.float32),
                           jnp.asarray(K, jnp.float32), Ti,
                           levels=levels, iters=tuple(iters),
                           dist_thresh=dist_thresh)
    return np.asarray(T), {"rmse": float(rmse), "inlier_frac": float(frac)}


@dataclasses.dataclass
class DepthOdometry:
    """Incremental tracker: feed depth frames, read world poses.

    Maintains ``T_wc`` (camera -> world) of the latest frame, composing
    frame-to-frame ICP motions; feed :attr:`T_cw` to
    :meth:`~i3dr_stereo_tpu.mapping.tsdf.TSDFVolume.integrate`. This is
    the rtabmap-odometry role of the reference processing graph in
    first-party form (launch/stereo_processing.launch:88-102).
    """

    K: np.ndarray
    levels: int = 3
    iters: Tuple[int, ...] = (4, 7, 10)
    dist_thresh: float = 0.5

    def __post_init__(self):
        self._prev = None
        self.T_wc = np.eye(4, dtype=np.float32)
        self.last_diag = {"rmse": 0.0, "inlier_frac": 0.0}

    @property
    def T_cw(self) -> np.ndarray:
        T = self.T_wc
        R, t = T[:3, :3], T[:3, 3]
        inv = np.eye(4, dtype=np.float32)
        inv[:3, :3] = R.T
        inv[:3, 3] = -R.T @ t
        return inv

    def track(self, depth: np.ndarray) -> np.ndarray:
        """Process one depth frame; returns the updated T_wc."""
        if self._prev is not None:
            T_pc, diag = estimate_motion(self._prev, depth, self.K,
                                         levels=self.levels,
                                         iters=self.iters,
                                         dist_thresh=self.dist_thresh)
            self.T_wc = (self.T_wc @ T_pc).astype(np.float32)
            self.last_diag = diag
        self._prev = np.asarray(depth, np.float32)
        return self.T_wc


# ---------------------------------------------------------------------------
# analytic scene renderer (tests / demos): depth of axis-aligned planes
# ---------------------------------------------------------------------------

def render_plane_depth(K, T_wc, planes, H: int, W: int,
                       z_max: float = 100.0) -> np.ndarray:
    """Ray-cast depth of a scene of finite planes from pose T_wc.

    ``planes``: list of (point, normal, half_extents) in world coords —
    the ray hits the plane iff the hit point lies within half_extents of
    ``point`` along every axis. Closed-form, host-side; exact ground
    truth for odometry tests (no stereo matching noise)."""
    K = np.asarray(K, np.float64)
    T_wc = np.asarray(T_wc, np.float64)
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    rays_c = np.stack([(u - K[0, 2]) / K[0, 0],
                       (v - K[1, 2]) / K[1, 1],
                       np.ones_like(u, np.float64)], axis=-1)
    Rwc, twc = T_wc[:3, :3], T_wc[:3, 3]
    rays_w = rays_c @ Rwc.T
    org = twc

    depth = np.full((H, W), np.inf)
    for point, normal, half in planes:
        p0 = np.asarray(point, np.float64)
        n = np.asarray(normal, np.float64)
        n = n / np.linalg.norm(n)
        denom = rays_w @ n
        tnum = (p0 - org) @ n
        with np.errstate(divide="ignore", invalid="ignore"):
            tt = np.where(np.abs(denom) > 1e-9, tnum / denom, np.inf)
        hit = rays_w * np.where(np.isfinite(tt), tt, 0.0)[..., None] + org
        inside = np.all(np.abs(hit - p0) <= np.asarray(half) + 1e-9, axis=-1)
        ok = (np.abs(denom) > 1e-9) & (tt > 1e-6) & inside
        z_cam = tt  # rays have unit z in camera frame -> t IS camera depth
        depth = np.where(ok & (z_cam < depth), z_cam, depth)
    depth = np.where(np.isfinite(depth) & (depth < z_max), depth, 0.0)
    return depth.astype(np.float32)
