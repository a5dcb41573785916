"""Scaling-efficiency artifact (BASELINE metric 3 harness).

Runs the sharded matcher over data-parallel CPU meshes of 1/2/4/8
virtual devices and prints throughput + efficiency (and writes them to
out.json if given). This measures the HARNESS on the virtual CPU mesh —
the same code path `dryrun_multichip` compiles for N devices — not
scaling across cards. Run:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scaling_bench.py [out.json]
"""

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from i3dr_stereo_tpu.config.params import ALGORITHM_DEFAULTS, Algorithm  # noqa: E402
from i3dr_stereo_tpu.dist.multihost import measure_scaling  # noqa: E402
from i3dr_stereo_tpu.dist.sharded import make_sharded_matcher  # noqa: E402
from i3dr_stereo_tpu.io.synthetic import layered_scene  # noqa: E402


def main(out_path: str | None = None) -> None:
    cfg = ALGORITHM_DEFAULTS[Algorithm.SGBM].replace(disparity_range=32,
                                                     speckle_size=0)

    def factory(mesh):
        return make_sharded_matcher(cfg, mesh, halo=0)

    def make_batch(n):
        sc = layered_scene(128, 160, max_disp=24, seed=0)
        # fixed per-device work: 2 frames per device
        L = np.stack([sc.left] * (2 * n))
        R = np.stack([sc.right] * (2 * n))
        return L, R

    res = measure_scaling(factory, make_batch, [1, 2, 4, 8], iters=5)
    rows = [{"devices": n, "frames_per_s": round(r["frames_per_s"], 2),
             "efficiency": round(r["efficiency"], 3)}
            for n, r in sorted(res.items())]
    doc = {"metric": "weak_scaling_cpu_mesh_sgbm_160x128_32d",
           "note": "virtual 8-device CPU mesh: all virtual devices share "
                   f"the host's {os.cpu_count()} physical cores, so "
                   "compute does not grow with N and weak-scaling "
                   "efficiency is bounded by cores/N, not by the sharding "
                   "design. It demonstrates the measurement harness + "
                   "sharded compilation at every mesh size.",
           "rows": rows}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(doc, f, indent=1)
    print(json.dumps(doc))


if __name__ == "__main__":
    main(*sys.argv[1:2])
