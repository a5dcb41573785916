"""Benchmark harness. Prints one JSON line per config:
{"metric": ..., "value": N, "unit": ..., "device": {...}, ...}

Configs (``BENCH_CONFIG=flagship|flagship_flat|sgbm_1280|bm_640|
pipeline_batch|e2e_2448|all``; default ``flagship``):

- flagship: pyramid census SGM at 2448x2048 with an effective 256-disparity
  search (the coarse-to-fine trick the reference's licensed engine uses),
  on a depth-varying layered scene;
- flagship_flat: the same on a constant-shift pair;
- sgbm_1280 / bm_640: the reference's SGBM and BM operating points;
- pipeline_batch: the fused rectify -> SGM -> depth step on 16 frames;
- e2e_2448: the full-resolution stream, host ingest included.

Every line names the device it ran on. Without a GPU the harness exits
non-zero: a time taken elsewhere is not a time of this system.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _device() -> dict:
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _synthetic_pair(h, w, max_disp=128, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h, w + max_disp)).astype(np.float32)
    # cheap band-limit so census/BT have gradients
    img = 0.25 * (np.roll(img, 1, 1) + np.roll(img, -1, 1)
                  + np.roll(img, 1, 0) + np.roll(img, -1, 0))
    left = img[:, max_disp:]
    return left, np.roll(left, -max_disp // 4, axis=1)


def _layered_pair(h, w, max_disp=200, seed=1):
    """Depth-varying scene with occlusions + discontinuities — the honest
    flagship input (a flat constant-shift pair is the pyramid predictor's
    best case; this one exercises prediction clamping, the backmatch and
    the speckle filter at every depth edge)."""
    from i3dr_stereo_tpu.io.synthetic import layered_scene

    sc = layered_scene(h, w, max_disp=max_disp, background_disp=16,
                       layers=6, seed=seed)
    return sc.left, sc.right


def _time_fn(fn, args, iters=5, warmup=2):
    """Median seconds per call of ``fn(*args)``, each run to completion
    with ``block_until_ready``, after ``warmup`` calls (compile included)."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def bench_flagship(pair=_layered_pair,
                   metric="sgm_disparity_fps_2448x2048_256d_per_chip"):
    """2448x2048, effective 256+ disparity coverage via the pyramid
    schedule, measured on a depth-varying layered scene (occlusions +
    discontinuities), NOT a constant-shift pair."""
    import jax

    from i3dr_stereo_tpu.matchers.registry import MATCHER_REGISTRY
    from i3dr_stereo_tpu.utils.smoke import flagship_config

    H, W = 2048, 2448
    cfg = flagship_config()
    impl = MATCHER_REGISTRY[cfg.algorithm]
    fn = jax.jit(lambda l, r: impl(l, r, cfg).disparity)
    l, r = pair(H, W)
    dt = _time_fn(fn, (jax.device_put(l[None]), jax.device_put(r[None])))
    return {"metric": metric, "value": 1.0 / dt, "unit": "frames/s"}


def bench_flagship_flat():
    """The constant-shift input: the pyramid predictor's best case."""
    return bench_flagship(pair=_synthetic_pair,
                          metric="sgm_disparity_fps_2448x2048_256d_flat")


def bench_sgbm_1280():
    import jax

    from i3dr_stereo_tpu.config.params import ALGORITHM_DEFAULTS, Algorithm
    from i3dr_stereo_tpu.matchers.registry import MATCHER_REGISTRY

    H, W = 1024, 1280
    cfg = ALGORITHM_DEFAULTS[Algorithm.SGBM].replace(
        disparity_range=128, window_size=5, speckle_size=0, num_directions=8)
    impl = MATCHER_REGISTRY[cfg.algorithm]
    fn = jax.jit(lambda l, r: impl(l, r, cfg).disparity)
    l, r = _synthetic_pair(H, W)
    dt = _time_fn(fn, (jax.device_put(l[None]), jax.device_put(r[None])))
    return {"metric": "sgbm8_fps_1280x1024_128d", "value": 1.0 / dt,
            "unit": "frames/s"}


def bench_bm_640():
    import jax

    from i3dr_stereo_tpu.config.params import ALGORITHM_DEFAULTS, Algorithm
    from i3dr_stereo_tpu.matchers.registry import MATCHER_REGISTRY

    H, W = 480, 640
    cfg = ALGORITHM_DEFAULTS[Algorithm.BM].replace(disparity_range=64,
                                                   speckle_size=0)
    impl = MATCHER_REGISTRY[cfg.algorithm]
    fn = jax.jit(lambda l, r: impl(l, r, cfg).disparity)
    l, r = _synthetic_pair(H, W)
    dt = _time_fn(fn, (jax.device_put(l[None]), jax.device_put(r[None])),
                  iters=20, warmup=3)
    return {"metric": "bm_fps_640x480_64d", "value": 1.0 / dt,
            "unit": "frames/s"}


def bench_pipeline_batch():
    """Fused rectify -> SGM -> depth on a batched stream, 16 frames per
    device call (BASELINE config 4)."""
    import jax

    from i3dr_stereo_tpu.config.params import ALGORITHM_DEFAULTS, Algorithm, PointCloudConfig
    from i3dr_stereo_tpu.core.camera import StereoRig
    from i3dr_stereo_tpu.pipeline.stereo_pipeline import StereoPipeline

    B, H, W = 16, 480, 640
    rig = StereoRig.synthetic(W, H, fx=500.0)
    cfg = ALGORITHM_DEFAULTS[Algorithm.SGBM].replace(disparity_range=64,
                                                     window_size=1, p1=8.0,
                                                     p2=32.0, speckle_size=0)
    pipe = StereoPipeline(rig=rig, config=cfg, compute_points=False,
                          cloud=PointCloudConfig(depth_max=100.0))
    l, r = _synthetic_pair(H, W)
    L = jax.device_put(np.broadcast_to(l, (B, H, W)).copy())
    R = jax.device_put(np.broadcast_to(r, (B, H, W)).copy())
    dt = _time_fn(pipe.process, (L, R), iters=3, warmup=1)
    return {"metric": "fused_pipeline_fps_640x480_64d_stream32x16",
            "value": B / dt, "unit": "frames/s"}


def _distorted_rig(H, W):
    """A real-shaped calibration (distortion + rotation), not the
    identity map of StereoRig.synthetic."""
    from scipy.spatial.transform import Rotation

    from i3dr_stereo_tpu.core.camera import CameraModel, StereoRig

    K = np.array([[2400.0, 0, 1224.0], [0, 2400.0, 1024.0], [0, 0, 1]])
    D = np.array([-0.18, 0.06, 0.0008, -0.0006, 0.0])
    Pl = np.array([[2380.0, 0, 1220.0, 0], [0, 2380.0, 1022.0, 0],
                   [0, 0, 1, 0]])
    Pr = Pl.copy()
    Pr[0, 3] = -2380.0 * 0.3      # Tx = -fx * B
    Rl = Rotation.from_rotvec([0.004, -0.006, 0.002]).as_matrix()
    Rr = Rotation.from_rotvec([-0.003, 0.005, -0.002]).as_matrix()
    return StereoRig(left=CameraModel(W, H, K, D, Rl, Pl),
                     right=CameraModel(W, H, K, D, Rr, Pr))


def bench_e2e_2448():
    """Full-resolution stream: host ingest (uint8 numpy -> device inside
    the timed loop, ~10 MB per frame pair) -> bicubic rectify -> pyramid
    SGM -> depth at 2448x2048, one fused program per frame
    (StereoPipeline.process with a distorted calibration; the rectify
    maps ride as traced arguments). Completion is forced once at the end
    of each run, so transfer of frame i+1 can overlap compute of frame i.
    Also reports the ingest-only rate and the device-resident step."""
    import jax

    from i3dr_stereo_tpu.config.params import PointCloudConfig
    from i3dr_stereo_tpu.io.synthetic import layered_scene
    from i3dr_stereo_tpu.pipeline.stereo_pipeline import StereoPipeline
    from i3dr_stereo_tpu.utils.smoke import flagship_config

    H, W = 2048, 2448
    pipe = StereoPipeline(
        rig=_distorted_rig(H, W), config=flagship_config(), rectify_inputs=True,
        compute_points=False, cloud=PointCloudConfig(depth_max=100.0))

    frames = []
    for i in range(3):
        sc = layered_scene(H, W, max_disp=200, background_disp=16,
                           layers=6, seed=10 + i)
        frames.append((sc.left.astype(np.uint8), sc.right.astype(np.uint8)))

    def run_stream(n, with_compute=True):
        outs = []
        t0 = time.perf_counter()
        for i in range(n):
            l, r = frames[i % len(frames)]
            L = jax.device_put(l)
            R = jax.device_put(r)
            outs.append(pipe.process(L, R).depth if with_compute else (L, R))
        jax.block_until_ready(outs)
        return (time.perf_counter() - t0) / n

    run_stream(2)            # compile + warm both paths
    run_stream(2, False)
    N = 6
    e2e = float(np.median([run_stream(N) for _ in range(3)]))
    ingest = float(np.median([run_stream(N, False) for _ in range(3)]))
    l0 = jax.device_put(frames[0][0])
    r0 = jax.device_put(frames[0][1])
    dt_step = _time_fn(lambda a, b: pipe.process(a, b).depth, (l0, r0),
                       iters=6, warmup=1)
    return {
        "metric": "e2e_fps_2448x2048_ingest_rectify_pyramidSGM_depth",
        "value": 1.0 / e2e,
        "unit": "frames/s",
        "ingest_only_fps": 1.0 / ingest,
        "device_resident_step_fps": 1.0 / dt_step,
        "peak_bytes_in_use": (jax.devices()[0].memory_stats() or {}).get(
            "peak_bytes_in_use"),
    }


BENCHES = {
    "flagship": bench_flagship,
    "e2e_2448": bench_e2e_2448,
    "flagship_flat": bench_flagship_flat,
    "sgbm_1280": bench_sgbm_1280,
    "bm_640": bench_bm_640,
    "pipeline_batch": bench_pipeline_batch,
}


def main():
    from i3dr_stereo_tpu.utils.compile_cache import enable_compile_cache

    dev = _device()
    if dev["platform"] != "gpu":
        raise SystemExit(f"bench.py: JAX's first device is "
                         f"{dev['platform']!r}, not a GPU")
    enable_compile_cache()
    which = os.environ.get("BENCH_CONFIG", "flagship")
    names = list(BENCHES) if which == "all" else [which]
    for name in names:
        print(json.dumps({**BENCHES[name](), "device": dev}), flush=True)


if __name__ == "__main__":
    main()
