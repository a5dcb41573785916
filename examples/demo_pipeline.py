"""End-to-end demo: synthetic capture -> fused device pipeline -> outputs.

    python examples/demo_pipeline.py [outdir]

Builds the live graph (capture + matcher, the stereo_camera.launch
analog), streams synthetic frames through it, saves a viewer montage,
a 16-bit disparity PNG and a point cloud, and prints the metrics the
reference never had.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from i3dr_stereo_tpu.bridge.launch import launch_stereo_camera, run_source
from i3dr_stereo_tpu.bridge.services import SaveStereoRequest
from i3dr_stereo_tpu.config.params import Algorithm
from i3dr_stereo_tpu.core.camera import StereoRig
from i3dr_stereo_tpu.io.sources import SyntheticStereoSource
from i3dr_stereo_tpu.utils.metrics import GLOBAL_METRICS
from i3dr_stereo_tpu.viz.viewer import StereoViewer


def main(outdir: str = "examples/out") -> None:
    os.makedirs(outdir, exist_ok=True)
    W, H = 640, 480
    rig = StereoRig.synthetic(W, H, fx=580.0, baseline_m=0.3)
    src = SyntheticStereoSource(width=W, height=H, n_frames=5, max_disp=48)

    # depth window sized to the synthetic rig: disparities 1..48 px at
    # fx*T = 174 are 3.6..174 m, so the reference's 10 m default clamp
    # (cfg/i3DR_pointCloud.cfg) would reject most of the scene
    from i3dr_stereo_tpu.config.params import PointCloudConfig

    lg = launch_stereo_camera(rig, stereo_algorithm=Algorithm.I3DRSGM,
                              source=src, rectify_inputs=False,
                              cloud=PointCloudConfig(depth_max=200.0,
                                                     depth_min=1.0))
    viewer = StereoViewer(lg.graph, "/stereo")

    with GLOBAL_METRICS.time("stream"):
        n = run_source(lg)

    node = lg.node("generate_disparity")
    view_path = viewer.save(os.path.join(outdir, "montage.png"))
    resp = lg.graph.call("/stereo/save_stereo",
                         SaveStereoRequest(folderpath=outdir))

    # accuracy against the synthetic ground truth of the last frame
    sc = src.scene(n - 1)
    _, _, _, res = node._last
    d = np.asarray(res.disparity)
    v = np.asarray(res.valid) & sc.valid
    err = np.abs(d - sc.disparity)[v]

    print(json.dumps({
        "frames": n,
        "processed": node.frames_processed,
        "montage": view_path,
        "saved": resp.paths,
        "density": round(float(v.mean()), 3),
        "median_err_px": round(float(np.median(err)), 4),
        "metrics": GLOBAL_METRICS.summary(),
    }, indent=2))


if __name__ == "__main__":
    main(*sys.argv[1:2])
