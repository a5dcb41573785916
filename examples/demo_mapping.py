"""End-to-end mapping demo: stereo frames -> matcher graph -> points2 ->
TSDF volume -> occupancy grid + voxel cloud PLY.

The reference's stereo_processing.launch feeds /points2 into rtabmap +
pcl tools (stereo_processing.launch:88-122); here the first-party TSDF
consumer (i3dr_stereo_tpu.mapping) fills that slot. Run from the
repository root:

    python examples/demo_mapping.py          # the GPU if JAX finds one
    JAX_PLATFORMS=cpu python examples/demo_mapping.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from i3dr_stereo_tpu.bridge.launch import launch_processing  # noqa: E402
from i3dr_stereo_tpu.config.params import ALGORITHM_DEFAULTS, Algorithm  # noqa: E402
from i3dr_stereo_tpu.core.camera import StereoRig  # noqa: E402
from i3dr_stereo_tpu.io.savers import save_ply  # noqa: E402
from i3dr_stereo_tpu.io.synthetic import layered_scene  # noqa: E402
from i3dr_stereo_tpu.mapping import TSDFVolume, make_map_consumer  # noqa: E402


def main() -> None:
    rig = StereoRig.synthetic(320, 240, fx=300.0, baseline_m=0.3)
    cfg = ALGORITHM_DEFAULTS[Algorithm.SGBM].replace(disparity_range=48,
                                                     speckle_size=0)
    vol = TSDFVolume(shape=(64, 64, 64), voxel_size=0.1,
                     origin=(-3.2, -3.2, 0.0))
    lg = launch_processing(rig, stereo_algorithm=Algorithm.SGBM, config=cfg,
                           rectify_inputs=False, with_crop=False,
                           warmup=False,
                           map_consumer=make_map_consumer(vol, rig))
    for i in range(4):
        sc = layered_scene(240, 320, max_disp=40, background_disp=16,
                           seed=i)
        lg.graph.publish("/stereo/left/image_raw", i * 0.2, sc.left)
        lg.graph.publish("/stereo/right/image_raw", i * 0.2, sc.right)

    pts = vol.occupied_points()
    occ = vol.occupancy_grid()
    out = os.path.join(os.path.dirname(__file__), "out")
    os.makedirs(out, exist_ok=True)
    ply = os.path.join(out, "map_voxels.ply")
    save_ply(ply, pts, None)
    print(json.dumps({
        "frames_integrated": vol.frames_integrated,
        "occupied_voxels": int(len(pts)),
        "occupancy_cells": int(occ.sum()),
        "z_range_m": [round(float(pts[:, 2].min()), 2),
                      round(float(pts[:, 2].max()), 2)] if len(pts) else None,
        "ply": ply,
    }))


if __name__ == "__main__":
    main()
