"""Mapping demo with a MOVING rig: depth frames from a camera sweeping
through a synthetic room are tracked by projective point-to-plane ICP
(i3dr_stereo_tpu.mapping.odometry — the rtabmap-odometry role of the
reference processing graph, launch/stereo_processing.launch:88-102) and
fused into the TSDF volume with the ESTIMATED poses. Prints the
trajectory error vs ground truth and the map agreement vs a
ground-truth-pose fusion. Run from the repository root:

    python examples/demo_mapping_moving.py
    JAX_PLATFORMS=cpu python examples/demo_mapping_moving.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from i3dr_stereo_tpu.mapping.odometry import (  # noqa: E402
    DepthOdometry,
    _se3_exp,
    render_plane_depth,
)
from i3dr_stereo_tpu.mapping.tsdf import TSDFVolume  # noqa: E402

H, W = 240, 320
K = np.array([[280.0, 0.0, 160.0], [0.0, 280.0, 120.0], [0.0, 0.0, 1.0]],
             np.float32)

SCENE = [
    ((0.0, 0.0, 3.0), (0.0, 0.0, -1.0), (3.0, 3.0, 0.01)),
    ((-1.0, 0.0, 2.2), (1.0, 0.0, -0.7), (0.6, 1.6, 0.7)),
    ((0.0, 0.9, 2.0), (0.0, -1.0, -0.4), (1.8, 0.5, 0.9)),
    ((0.45, -0.25, 1.6), (0.0, 0.0, -1.0), (0.35, 0.25, 0.01)),
]


def main() -> None:
    rng = np.random.default_rng(3)
    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(9):
        step = np.asarray(_se3_exp(np.array(
            [np.radians(rng.normal(0, 0.1)),
             np.radians(0.6 + rng.normal(0, 0.1)), 0.0,
             0.025 + rng.normal(0, 0.003), rng.normal(0, 0.003),
             0.02 + rng.normal(0, 0.003)], np.float32)), np.float32)
        poses.append((poses[-1] @ step).astype(np.float32))
    depths = [render_plane_depth(K, T, SCENE, H, W) for T in poses]

    odo = DepthOdometry(K=K)
    est = [odo.track(d).copy() for d in depths]
    ate = [float(np.linalg.norm(e[:3, 3] - g[:3, 3]))
           for e, g in zip(est, poses)]

    def fuse(pose_list):
        vol = TSDFVolume(shape=(64, 64, 64), voxel_size=0.08,
                         origin=(-2.0, -2.0, 0.0))
        for d, T_wc in zip(depths, pose_list):
            vol.integrate(d, K, np.linalg.inv(T_wc).astype(np.float32))
        return vol

    occ_gt = fuse(poses).occupancy_grid()
    occ_est = fuse(est).occupancy_grid()
    iou = float((occ_gt & occ_est).sum() / max((occ_gt | occ_est).sum(), 1))

    print(json.dumps({
        "frames": len(depths),
        "ate_max_m": round(max(ate), 4),
        "ate_final_m": round(ate[-1], 4),
        "last_icp_rmse_m": round(odo.last_diag["rmse"], 4),
        "map_iou_vs_gt_poses": round(iou, 3),
    }))


if __name__ == "__main__":
    main()
