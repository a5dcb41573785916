"""TSDF voxel mapping — the downstream consumer of the cloud topic.

The reference's stereo_processing.launch wires EXTERNAL mapping packages
(i3dr_rtabmap + pcl voxel/passthrough tools) onto /points2
(stereo_processing.launch:88-122); the framework side of that contract
is the ``map_consumer`` hook of
:func:`i3dr_stereo_tpu.bridge.launch.launch_processing`. This module is
a first-party consumer for that hook: a truncated-signed-distance-field
(TSDF) voxel volume fused from the pipeline's depth output.

Design — **voxel-projective** integration (the KinectFusion
update turned inside-out for XLA):

- instead of scattering points into voxels (colliding scatters serialize),
  every voxel center is PROJECTED into the current depth image and reads
  the depth along its ray with one flat gather — the classic
  gather-formulated TSDF update, embarrassingly parallel over the
  (X, Y, Z) grid, jitted once for the volume shape;
- the running average ``tsdf = (w*tsdf + t_new) / (w+1)`` is pure
  elementwise; the whole integrate step is a single fused XLA program
  with static shapes (fixed grid, fixed image size);
- surface / occupancy extraction are reductions (no marching cubes
  needed for the reference parity target — pcl's voxel-grid output is a
  point-per-occupied-voxel, which is exactly ``occupied_points``).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("trunc_vox",))
def _integrate(tsdf, weight, depth, K, T_cw, origin, voxel_size,
               trunc_vox: int = 3):
    """One TSDF fusion step. tsdf/weight: (X, Y, Z); depth: (H, W) metres
    (0 = invalid); K: (3, 3) intrinsics; T_cw: (4, 4) world->camera."""
    X, Y, Z = tsdf.shape
    H, W = depth.shape
    trunc = trunc_vox * voxel_size

    ii = jax.lax.broadcasted_iota(jnp.float32, (X, Y, Z), 0)
    jj = jax.lax.broadcasted_iota(jnp.float32, (X, Y, Z), 1)
    kk = jax.lax.broadcasted_iota(jnp.float32, (X, Y, Z), 2)
    wx = origin[0] + (ii + 0.5) * voxel_size
    wy = origin[1] + (jj + 0.5) * voxel_size
    wz = origin[2] + (kk + 0.5) * voxel_size

    cx = T_cw[0, 0] * wx + T_cw[0, 1] * wy + T_cw[0, 2] * wz + T_cw[0, 3]
    cy = T_cw[1, 0] * wx + T_cw[1, 1] * wy + T_cw[1, 2] * wz + T_cw[1, 3]
    cz = T_cw[2, 0] * wx + T_cw[2, 1] * wy + T_cw[2, 2] * wz + T_cw[2, 3]

    u = K[0, 0] * cx / cz + K[0, 2]
    v = K[1, 1] * cy / cz + K[1, 2]
    ui = jnp.round(u).astype(jnp.int32)
    vi = jnp.round(v).astype(jnp.int32)
    in_img = (cz > 1e-6) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    flat = jnp.clip(vi, 0, H - 1) * W + jnp.clip(ui, 0, W - 1)
    d = jnp.take(depth.ravel(), flat.ravel()).reshape(X, Y, Z)

    sdf = d - cz                       # + in front of surface, - behind
    seen = in_img & (d > 0.0) & (sdf > -trunc)
    t_new = jnp.clip(sdf / trunc, -1.0, 1.0)
    w_new = jnp.where(seen, 1.0, 0.0)
    w_tot = weight + w_new
    tsdf_out = jnp.where(w_tot > 0.0,
                         (tsdf * weight + t_new * w_new)
                         / jnp.maximum(w_tot, 1e-9),
                         tsdf)
    return tsdf_out, w_tot


@dataclasses.dataclass
class TSDFVolume:
    """Fixed world-aligned voxel grid accumulating TSDF from depth maps.

    ``shape`` voxels of ``voxel_size`` metres anchored at ``origin``
    (world coords of the grid's min corner). Camera poses are 4x4
    world->camera transforms (identity = camera at world origin looking
    +Z, the rig's optical convention).
    """

    shape: Tuple[int, int, int] = (96, 96, 96)
    voxel_size: float = 0.05
    origin: Tuple[float, float, float] = (-2.4, -2.4, 0.0)
    trunc_vox: int = 3

    def __post_init__(self):
        self.tsdf = jnp.zeros(self.shape, jnp.float32)
        self.weight = jnp.zeros(self.shape, jnp.float32)
        self.frames_integrated = 0

    def integrate(self, depth, K, T_cw: Optional[np.ndarray] = None) -> None:
        """Fuse one depth map (H, W) metres with intrinsics K and camera
        pose T_cw (default identity)."""
        T = jnp.asarray(np.eye(4, dtype=np.float32) if T_cw is None
                        else T_cw, jnp.float32)
        self.tsdf, self.weight = _integrate(
            self.tsdf, self.weight, jnp.asarray(depth, jnp.float32),
            jnp.asarray(K, jnp.float32), T,
            jnp.asarray(self.origin, jnp.float32),
            jnp.float32(self.voxel_size), trunc_vox=self.trunc_vox)
        self.frames_integrated += 1

    # -- outputs ----------------------------------------------------------

    def occupied_points(self, *, band: float = 0.5, min_weight: float = 1.0
                        ) -> np.ndarray:
        """World-coordinate centers of near-surface voxels — the pcl
        voxel-grid analog of the mapping chain's output (one point per
        occupied voxel). Host-side compaction (dynamic count)."""
        t = np.asarray(self.tsdf)
        w = np.asarray(self.weight)
        sel = (np.abs(t) < band) & (w >= min_weight)
        idx = np.argwhere(sel).astype(np.float32)
        return np.asarray(self.origin, np.float32) + \
            (idx + 0.5) * np.float32(self.voxel_size)

    def occupancy_grid(self, *, band: float = 0.5, min_weight: float = 1.0
                       ) -> np.ndarray:
        """(X, Y) top-down occupancy projection (max over Z) — the 2D
        costmap-style view a navigation consumer wants."""
        t = np.asarray(self.tsdf)
        w = np.asarray(self.weight)
        return ((np.abs(t) < band) & (w >= min_weight)).any(axis=2)


def make_map_consumer(volume: TSDFVolume, rig, *, pose_lookup=None):
    """Bind a TSDFVolume to the ``map_consumer`` hook of
    :func:`~i3dr_stereo_tpu.bridge.launch.launch_processing`.

    The hook delivers (stamp, points2-dict); the consumer rebuilds the
    ordered depth image from the cloud's Z channel (points2 is organized
    H*W like the reference's organized cloud) and integrates it.
    ``pose_lookup(stamp) -> 4x4 T_cw`` supplies per-frame camera poses
    (a SLAM front-end's job — rtabmap in the reference graph); default
    is a static camera.
    """
    K = np.array([[rig.left.fx, 0.0, rig.left.cx],
                  [0.0, rig.left.fy, rig.left.cy],
                  [0.0, 0.0, 1.0]], np.float32)
    H, W = rig.left.height, rig.left.width

    def consume(stamp, points) -> None:
        xyz = np.asarray(points["xyz"]).reshape(H, W, 3)
        valid = np.asarray(points["valid"]).reshape(H, W)
        depth = np.where(valid, xyz[..., 2], 0.0).astype(np.float32)
        T = None if pose_lookup is None else pose_lookup(stamp)
        volume.integrate(depth, K, T)

    return consume
