"""Checks shared by ``chip_smoke.py`` and the tests marked ``gpu``.

Each function drives one piece of the system through its public entry
points and returns plain numbers; the callers decide the sizes and the
gates. Times are host wall-clock around work that ends in
``block_until_ready``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from i3dr_stereo_tpu.config.params import ALGORITHM_DEFAULTS, Algorithm, MatcherConfig

BACKEND_ENV = "I3DR_SGM_BACKEND"


@contextlib.contextmanager
def sgm_backend(name: str):
    """Trace what runs inside with ``I3DR_SGM_BACKEND=name``."""
    old = os.environ.get(BACKEND_ENV)
    os.environ[BACKEND_ENV] = name
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(BACKEND_ENV, None)
        else:
            os.environ[BACKEND_ENV] = old


def median_seconds(fn: Callable[[], object], repeats: int = 5) -> float:
    """Median wall time of ``fn()`` run to completion, after one warm-up."""
    jax.block_until_ready(fn())
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def flagship_config() -> MatcherConfig:
    """The flagship operating point: pyramid census SGM, 256 disparities."""
    return ALGORITHM_DEFAULTS[Algorithm.I3DRSGM].replace(
        disparity_range=256, max_pyramid_level=4,
        speckle_size=100, speckle_downsample=2, median_filter=True)


def census_like_costs(shape: Tuple[int, ...], seed: int) -> jax.Array:
    """Whole-number costs in the 9x9 census range (0..80) with the
    BIG entries a shifted cost window produces at the left border."""
    from i3dr_stereo_tpu.ops.sgm import BIG

    rng = np.random.default_rng(seed)
    C = rng.integers(0, 81, shape).astype(np.float32)
    D = shape[-1]
    for k in range(min(D, shape[-2])):  # column x sees only d <= x
        C[..., k, k + 1:] = BIG
    return jnp.asarray(C)


def sgm_parity(shape: Tuple[int, int, int, int],
               directions: Sequence[Tuple[int, int]],
               penalties: Sequence[Tuple[float, float]], *, seed: int = 0,
               interpret: bool = False, repeats: int = 0) -> dict:
    """The kernel against :func:`ops.sgm.sgm_aggregate` on one cost volume.

    Returns whether the two sums are bit-identical, their largest
    absolute difference, and (``repeats`` > 0) both median times."""
    from i3dr_stereo_tpu.ops.sgm import sgm_aggregate
    from i3dr_stereo_tpu.ops.sgm_triton import sgm_aggregate_triton

    dirs = tuple(tuple(d) for d in directions)
    pens = tuple((float(a), float(b)) for a, b in penalties)
    C = census_like_costs(shape, seed)
    ref_fn = jax.jit(lambda c: sgm_aggregate(
        c, directions=dirs, per_direction_penalties=pens))
    ker_fn = jax.jit(lambda c: sgm_aggregate_triton(
        c, directions=dirs, per_direction_penalties=pens,
        interpret=interpret))
    ref = np.asarray(ref_fn(C))
    ker = np.asarray(ker_fn(C))
    out = {"shape": list(shape), "paths": len(dirs),
           "bit_exact": bool(np.array_equal(ref, ker)),
           "max_abs": float(np.max(np.abs(ref - ker))),
           "max_sum": float(np.max(np.abs(ref)))}
    if repeats:
        out["kernel_ms"] = median_seconds(lambda: ker_fn(C), repeats) * 1e3
        out["ref_ms"] = median_seconds(lambda: ref_fn(C), repeats) * 1e3
    return out


def scene_error(disp, valid, scene) -> dict:
    """Median |error| and density against a synthetic scene's truth."""
    disp = np.asarray(disp)
    valid = np.asarray(valid)
    gt_ok = scene.valid
    sel = valid & gt_ok
    err = np.abs(disp - scene.disparity)[sel]
    return {"median_abs_err_px": float(np.median(err)) if err.size else float("inf"),
            "density": float(sel.sum() / max(gt_ok.sum(), 1)),
            "finite": bool(np.isfinite(disp[valid]).all())}


def identical_fraction(disp_a, valid_a, disp_b, valid_b) -> float:
    """Share of pixels with the same validity and, where valid, the same
    disparity value."""
    disp_a, disp_b = np.asarray(disp_a), np.asarray(disp_b)
    valid_a, valid_b = np.asarray(valid_a), np.asarray(valid_b)
    same = (valid_a == valid_b) & (~valid_a | (disp_a == disp_b))
    return float(same.mean())


def run_pipeline(pipe, left, right, *, repeats: int = 5) -> dict:
    """Drive ``StereoPipeline.process``: first call (trace + compile +
    run), median step time, the step's compiled memory analysis and the
    device's peak memory."""
    t0 = time.perf_counter()
    res = jax.block_until_ready(pipe.process(left, right))
    first_s = time.perf_counter() - t0
    out = {"result": res, "first_call_s": first_s}
    if repeats:
        step_s = median_seconds(lambda: pipe.process(left, right), repeats)
        out["step_ms"] = step_s * 1e3
        out["compile_s"] = max(first_s - step_s, 0.0)
    fn = next(reversed(pipe._cache.values()))
    args = (jnp.asarray(left), jnp.asarray(right), pipe._dyn_values(),
            pipe._lmap, pipe._rmap, pipe._Q)
    out["memory_analysis"] = fn.lower(*args).compile().memory_analysis()
    stats = jax.devices()[0].memory_stats() or {}
    out["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    return out


def run_live_graph(rig, cfg: MatcherConfig, cloud, source, n_frames: int,
                   namespace: str = "/stereo") -> list:
    """The ``cli live`` path: launch the live graph, feed it ``n_frames``
    from ``source`` and return the published (stamp, disparity, valid)."""
    from i3dr_stereo_tpu.bridge.launch import launch_stereo_camera, run_source

    lg = launch_stereo_camera(rig, stereo_algorithm=cfg.algorithm,
                              namespace=namespace, source=source,
                              config=cfg, cloud=cloud)
    got = []
    lg.graph.subscribe(f"{namespace}/disparity", lambda stamp, msg: got.append(
        (stamp, msg["disparity"], msg["valid"])))
    fed = run_source(lg, namespace=namespace, n_frames=n_frames)
    node = lg.node("generate_disparity")
    if fed != n_frames or node.frames_processed != n_frames or node.frames_dropped:
        raise RuntimeError(f"live graph: fed {fed}, processed "
                           f"{node.frames_processed}, dropped "
                           f"{node.frames_dropped} of {n_frames} frames")
    return got


def sharded_agreement(disp_s, valid_s, disp_1, valid_1, cuts: Sequence[int],
                      margin: int) -> dict:
    """The sharded-vs-unsharded criterion: share of pixels valid in both
    runs, more than ``margin`` rows from every cut, whose disparities
    differ by less than 1 px."""
    d_s, d_1 = np.asarray(disp_s), np.asarray(disp_1)
    v = np.asarray(valid_s) & np.asarray(valid_1)
    H = d_s.shape[-2]
    away = np.ones(H, bool)
    for c in cuts:
        away[max(c - margin, 0):c + margin] = False
    sel = v & away[:, None]
    agree = (np.abs(d_s - d_1) < 1.0)[sel]
    return {"agreement": float(agree.mean()) if agree.size else 0.0,
            "compared_share": float(sel.mean())}
