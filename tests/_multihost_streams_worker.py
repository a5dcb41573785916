"""Worker for the BASELINE config-5 miniature (4 stereo streams x tiled
batches over a real 2-process jax.distributed mesh) — run by
multihost_streams_bench.py, one subprocess per simulated host.

Each of the 4 streams is an independent stereo camera pair whose frames
are split into tiles; every batch holds one tile per global device
(data-parallel over the full 2-process mesh, the multi-host layout of
BASELINE config 5). Streams share the mesh round-robin — 4 concurrent
streams contending for the same devices, like 4 capture nodes feeding
one cluster. Per-stream throughput, accuracy vs synthetic GT, and the
cross-host collective (a global valid-count all-reduce that XLA lowers
to a 2-process psum) are recorded.

Usage: python _multihost_streams_worker.py <pid> <port> <out_json>
"""

import json
import os
import sys
import time

PID = int(sys.argv[1])
PORT = sys.argv[2]
OUT = sys.argv[3]
NPROCS = int(sys.argv[4]) if len(sys.argv) > 4 else 2

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.distributed.initialize(coordinator_address=f"localhost:{PORT}",
                           num_processes=NPROCS, process_id=PID)

import numpy as np  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402

from i3dr_stereo_tpu.config.params import ALGORITHM_DEFAULTS, Algorithm  # noqa: E402
from i3dr_stereo_tpu.dist.mesh import make_mesh  # noqa: E402
from i3dr_stereo_tpu.dist.multihost import global_frame_batch  # noqa: E402
from i3dr_stereo_tpu.dist.sharded import make_sharded_matcher  # noqa: E402
from i3dr_stereo_tpu.io.synthetic import layered_scene  # noqa: E402

N_STREAMS = 4
N_BATCHES = 3
TILE_H, TILE_W = 32, 48


def main() -> None:
    assert jax.process_count() == NPROCS
    n_global = len(jax.devices())
    n_local = len(jax.local_devices())
    mesh = make_mesh(n_global, 1)

    cfg = ALGORITHM_DEFAULTS[Algorithm.BM].replace(disparity_range=16,
                                                   speckle_size=0,
                                                   texture_threshold=0.0)
    matcher = make_sharded_matcher(cfg, mesh, halo=0)
    count_valid = jax.jit(lambda v: v.astype(np.float32).sum())

    # per-stream tile sequences (deterministic; both hosts generate the
    # same global sequence, then keep their half)
    streams = []
    for s in range(N_STREAMS):
        batches = []
        for b in range(N_BATCHES):
            scenes = [layered_scene(TILE_H, TILE_W, max_disp=8,
                                    background_disp=4,
                                    seed=1000 * s + 10 * b + t)
                      for t in range(n_global)]
            L = np.stack([sc.left for sc in scenes])
            R = np.stack([sc.right for sc in scenes])
            GT = np.stack([sc.disparity for sc in scenes])
            V = np.stack([sc.valid for sc in scenes])
            batches.append((L, R, GT, V))
        streams.append(batches)

    # warmup (compile once, off the clock)
    L0, R0, _, _ = streams[0][0]
    gl, gr = global_frame_batch(mesh, L0[PID * n_local:(PID + 1) * n_local],
                                R0[PID * n_local:(PID + 1) * n_local])
    matcher(gl, gr).disparity.block_until_ready()

    # 4 concurrent streams, round-robin over the shared mesh
    per_stream = [{"tiles": 0, "seconds": 0.0, "errs": [], "valid_px": 0.0}
                  for _ in range(N_STREAMS)]
    for b in range(N_BATCHES):
        for s in range(N_STREAMS):
            L, R, GT, V = streams[s][b]
            lb = L[PID * n_local:(PID + 1) * n_local]
            rb = R[PID * n_local:(PID + 1) * n_local]
            t0 = time.perf_counter()
            gl, gr = global_frame_batch(mesh, lb, rb)
            res = matcher(gl, gr)
            # cross-host collective: global valid count (psum over the
            # 2-process mesh inserted by XLA for the sharded reduce)
            nv = float(count_valid(res.valid))
            dt = time.perf_counter() - t0
            st = per_stream[s]
            st["tiles"] += n_global
            st["seconds"] += dt
            st["valid_px"] += nv
            d = np.asarray(multihost_utils.process_allgather(
                res.disparity, tiled=True))
            v = np.asarray(multihost_utils.process_allgather(
                res.valid, tiled=True)) & V
            st["errs"].append(float(np.median(np.abs(d - GT)[v])))

    if PID == 0:
        rows = []
        for s, st in enumerate(per_stream):
            rows.append({
                "stream": s,
                "tiles": st["tiles"],
                "batches": N_BATCHES,
                "tiles_per_s": round(st["tiles"] / max(st["seconds"], 1e-9),
                                     1),
                "median_px_vs_gt": round(float(np.median(st["errs"])), 4),
                "collective_valid_px": st["valid_px"],
            })
        total_tiles = sum(st["tiles"] for st in per_stream)
        total_secs = sum(st["seconds"] for st in per_stream)
        doc = {"ok": all(r["median_px_vs_gt"] < 0.5 for r in rows),
               "processes": jax.process_count(),
               "global_devices": n_global,
               "total_tiles_per_s": round(total_tiles
                                          / max(total_secs, 1e-9), 1),
               "tiles_per_s_per_device": round(
                   total_tiles / max(total_secs, 1e-9) / n_global, 2),
               "streams": N_STREAMS,
               "tile_hw": [TILE_H, TILE_W],
               "collective": "global valid-count all-reduce over the "
                             "2-process data mesh (XLA psum) per batch",
               "note": "BASELINE config 5 in miniature: 4 concurrent "
                       "stereo streams x per-device tiled batches on a "
                       "real 2-process jax.distributed mesh",
               "rows": rows}
        with open(OUT, "w") as f:
            json.dump(doc, f, indent=1)


main()
