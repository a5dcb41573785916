"""Smoke test of the stereo pipeline on one NVIDIA GPU.

    python chip_smoke.py [--seed N]     # one GPU, every phase below
    python chip_smoke.py --four         # four GPUs: the sharded path only

Phases, all in this one process (the card is never shared with a second
JAX process):

1. device: JAX's first device must be a GPU; prints its kind, the device
   count, the compile cache directory, and nvidia-smi's name and power
   limit.
2. SGM kernel parity at real widths: the Pallas kernel against the plain
   reference ``ops.sgm.sgm_aggregate`` at flagship level 0
   (1x2048x2448x32, 4 paths, per-direction penalties) and at the SGBM
   operating point (1x1024x1280x128, 8 paths). Integer penalties must be
   bit-exact; fractional ones are held to a relative 1e-6 (see FRACTIONAL_RTOL).
   Both are timed, then the whole flagship step with each.
3. flagship end to end at 2448x2048: ``StereoPipeline.process`` and five
   frames through the live graph (``launch_stereo_camera`` +
   ``run_source``), against the synthetic scene's ground truth (median
   |error| < 0.25 px), kernel against reference (>= 99.9% identical).
4. the other matchers: SGBM (1280x1024, 128 disparities, 8 paths) and BM
   (640x480, 64 disparities), each against its reference-aggregation run.

Any failed gate raises, and the script exits non-zero. The last line of a
passing run is one JSON object: ``{"ok": true, "device": {...}}``.

``--rehearse --no-gpu-check`` runs the same phases on the CPU at tiny
sizes, with the kernel in the Pallas interpreter; it never prints
``"ok": true``. ``--no-gpu-check`` is refused without ``--rehearse``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# Integer costs and penalties keep every sum a whole number below 2**24,
# so kernel and reference agree bit for bit. With fractional penalties
# both still run the same float32 operations in the same order; the
# tolerance only allows for a compiler that rounds an operation
# differently, a few ulps of the largest sum.
FRACTIONAL_RTOL = 1e-6
ACCURACY_GATE_PX = 0.25      # accuracy_bench.py's gate
IDENTICAL_GATE = 0.999       # kernel vs reference disparity maps
SHARDED_GATE = 0.99          # tests/test_dist.py's criterion


def log(*parts):
    print(*parts, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# -------------------------------------------------------------- sizes ----

class Sizes:
    """Real widths on the card; tiny ones for the CPU rehearsal."""

    def __init__(self, rehearse: bool):
        if rehearse:
            self.flagship_hw = (96, 128)
            self.flagship_vol = (1, 96, 128, 32)
            self.sgbm_vol = (1, 48, 64, 32)
            self.sgbm_hw, self.sgbm_disp = (48, 64), 32
            self.bm_hw, self.bm_disp = (48, 64), 16
            self.live_frames = 2
            self.repeats = 1
            self.max_disp = 24
            self.four_hw = (384, 128)
        else:
            self.flagship_hw = (2048, 2448)
            self.flagship_vol = (1, 2048, 2448, 32)
            self.sgbm_vol = (1, 1024, 1280, 128)
            self.sgbm_hw, self.sgbm_disp = (1024, 1280), 128
            self.bm_hw, self.bm_disp = (480, 640), 64
            self.live_frames = 5
            self.repeats = 5
            self.max_disp = 200
            self.four_hw = (2048, 2448)


# -------------------------------------------------------------- phases ---

def phase_device(args):
    import jax

    from i3dr_stereo_tpu.utils.compile_cache import enable_compile_cache

    devs = jax.devices()
    platform = devs[0].platform
    if platform != "gpu" and not args.no_gpu_check:
        fail(f"JAX's first device is {platform!r}, not a GPU")
    cache = enable_compile_cache()
    log(f"[device] platform={platform} kind={devs[0].device_kind} "
        f"count={len(devs)} compile_cache={cache}")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        if not args.rehearse:
            fail(f"nvidia-smi: {e}")
        smi = "not available (rehearsal)"
    log(f"[device] nvidia-smi: {smi}")
    return devs


def phase_kernel(args, sz):
    from i3dr_stereo_tpu.ops.sgm import DIRECTIONS_4, DIRECTIONS_8
    from i3dr_stereo_tpu.utils.smoke import sgm_parity

    pens4 = ((7.0, 60.0), (8.0, 64.0), (9.0, 70.0), (10.0, 80.0))
    cases = [("flagship_L0", sz.flagship_vol, DIRECTIONS_4, pens4),
             ("sgbm_1280", sz.sgbm_vol, DIRECTIONS_8, ((8.0, 32.0),) * 8)]
    for name, shape, dirs, pens in cases:
        r = sgm_parity(shape, dirs, pens, seed=args.seed,
                       interpret=args.rehearse, repeats=sz.repeats)
        log(f"[kernel] {name} shape={r['shape']} paths={r['paths']} "
            f"integer penalties: bit_exact={r['bit_exact']} "
            f"max_abs={r['max_abs']} kernel_ms={r['kernel_ms']:.3f} "
            f"reference_ms={r['ref_ms']:.3f}")
        check(r["bit_exact"], f"{name}: kernel differs from the reference")
    frac = ((7.5, 60.25), (8.25, 64.5), (9.75, 70.0), (10.5, 80.75))
    r = sgm_parity(sz.flagship_vol, DIRECTIONS_4, frac, seed=args.seed + 1,
                   interpret=args.rehearse)
    tol = FRACTIONAL_RTOL * r["max_sum"]
    log(f"[kernel] flagship_L0 fractional penalties: bit_exact="
        f"{r['bit_exact']} max_abs={r['max_abs']} tolerance={tol} "
        f"(relative {FRACTIONAL_RTOL} of the largest sum)")
    check(r["max_abs"] <= tol, "fractional penalties beyond tolerance")


def _rig(H: int, W: int):
    from i3dr_stereo_tpu.core.camera import StereoRig

    return StereoRig.synthetic(W, H, fx=2400.0, baseline_m=0.3)


def phase_flagship(args, sz, kernel_backend):
    import numpy as np

    from i3dr_stereo_tpu.config.params import PointCloudConfig
    from i3dr_stereo_tpu.io.sources import SyntheticStereoSource
    from i3dr_stereo_tpu.io.synthetic import layered_scene
    from i3dr_stereo_tpu.pipeline.stereo_pipeline import StereoPipeline
    from i3dr_stereo_tpu.utils.smoke import (flagship_config, identical_fraction,
                                             run_pipeline, run_live_graph,
                                             scene_error, sgm_backend)

    H, W = sz.flagship_hw
    rig = _rig(H, W)
    cfg = flagship_config()
    cloud = PointCloudConfig(depth_max=1000.0)
    sc = layered_scene(H, W, max_disp=sz.max_disp, background_disp=16,
                       layers=6, seed=args.seed)
    left = np.clip(sc.left, 0, 255).astype(np.uint8)
    right = np.clip(sc.right, 0, 255).astype(np.uint8)

    runs = {}
    for label, backend in (("kernel", kernel_backend), ("reference", "xla")):
        with sgm_backend(backend):
            pipe = StereoPipeline(rig=rig, config=cfg, cloud=cloud,
                                  interpolation="cubic",
                                  compute_depth=True, compute_points=True)
            r = run_pipeline(pipe, left, right, repeats=sz.repeats)
        res = r["result"]
        err = scene_error(res.disparity, res.valid, sc)
        runs[label] = res
        log(f"[flagship] {label}: {W}x{H} step_ms={r['step_ms']:.3f} "
            f"first_call_s={r['first_call_s']:.3f} "
            f"compile_s={r['compile_s']:.3f} "
            f"median_abs_err_px={err['median_abs_err_px']:.4f} "
            f"density={err['density']:.4f}")
        log(f"[flagship] {label}: memory_analysis={r['memory_analysis']}")
        log(f"[flagship] {label}: process_peak_bytes_in_use="
            f"{r['peak_bytes_in_use']}")
        check(err["finite"], f"{label}: non-finite disparities")
        check(err["median_abs_err_px"] < ACCURACY_GATE_PX,
              f"{label}: median |error| {err['median_abs_err_px']} px")
        check(res.depth is not None and res.points is not None,
              "depth and points are on")
    same = identical_fraction(runs["kernel"].disparity, runs["kernel"].valid,
                              runs["reference"].disparity,
                              runs["reference"].valid)
    log(f"[flagship] kernel vs reference: identical_share={same:.6f}")
    check(same >= IDENTICAL_GATE, f"kernel vs reference identical {same}")

    src = SyntheticStereoSource(width=W, height=H, n_frames=sz.live_frames,
                                max_disp=sz.max_disp, seed=args.seed)
    with sgm_backend(kernel_backend):
        t0 = time.perf_counter()
        got = run_live_graph(rig, cfg, cloud, src, sz.live_frames)
        live_s = time.perf_counter() - t0
    for i, (stamp, disp, valid) in enumerate(got):
        err = scene_error(disp, valid, src.scene(i))
        log(f"[live] frame {i} stamp={stamp:.3f} "
            f"median_abs_err_px={err['median_abs_err_px']:.4f} "
            f"density={err['density']:.4f}")
        check(err["finite"], f"live frame {i}: non-finite disparities")
        check(err["median_abs_err_px"] < ACCURACY_GATE_PX,
              f"live frame {i}: median |error| {err['median_abs_err_px']}")
    log(f"[live] {len(got)} frames through the live graph in {live_s:.3f} s "
        f"(compile included)")


def phase_matchers(args, sz, kernel_backend):
    import numpy as np

    from i3dr_stereo_tpu.config.params import ALGORITHM_DEFAULTS, Algorithm
    from i3dr_stereo_tpu.io.synthetic import layered_scene
    from i3dr_stereo_tpu.matchers.registry import MATCHER_REGISTRY
    from i3dr_stereo_tpu.utils.smoke import (identical_fraction, scene_error,
                                             sgm_backend)

    cases = [
        ("SGBM", sz.sgbm_hw, ALGORITHM_DEFAULTS[Algorithm.SGBM].replace(
            disparity_range=sz.sgbm_disp, window_size=5, speckle_size=0,
            num_directions=8)),
        ("BM", sz.bm_hw, ALGORITHM_DEFAULTS[Algorithm.BM].replace(
            disparity_range=sz.bm_disp, speckle_size=0)),
    ]
    for name, (H, W), cfg in cases:
        cfg = cfg.sanitize()
        sc = layered_scene(H, W, max_disp=cfg.disparity_range * 3 // 4,
                           seed=args.seed + 5)
        impl = MATCHER_REGISTRY[cfg.algorithm]
        out = {}
        for label, backend in (("kernel", kernel_backend), ("reference", "xla")):
            with sgm_backend(backend):
                res = impl(sc.left, sc.right, cfg)
                out[label] = (np.asarray(res.disparity), np.asarray(res.valid))
        same = identical_fraction(*out["kernel"], *out["reference"])
        err = scene_error(*out["kernel"], sc)
        log(f"[matcher] {name} {W}x{H} d={cfg.disparity_range}: "
            f"identical_share={same:.6f} "
            f"median_abs_err_px={err['median_abs_err_px']:.4f} "
            f"density={err['density']:.4f}")
        check(err["finite"], f"{name}: non-finite disparities")
        check(err["density"] > 0.0, f"{name}: no valid pixel")
        check(same >= IDENTICAL_GATE, f"{name}: kernel vs reference {same}")


def phase_four(args, sz, kernel_backend):
    """The sharded pipeline step at flagship width on meshes 4x1 and 1x4,
    each against the same step built on a 1x1 mesh."""
    import jax
    import numpy as np

    from i3dr_stereo_tpu.config.params import PointCloudConfig
    from i3dr_stereo_tpu.dist.mesh import make_mesh
    from i3dr_stereo_tpu.dist.sharded import make_sharded_pipeline_step
    from i3dr_stereo_tpu.io.synthetic import layered_scene
    from i3dr_stereo_tpu.utils.smoke import (flagship_config, scene_error,
                                             sgm_backend, sharded_agreement)

    check(len(jax.devices()) >= 4, f"--four needs 4 devices, "
          f"have {len(jax.devices())}")
    H, W = sz.four_hw
    rig = _rig(H, W)
    cfg = flagship_config()
    cloud = PointCloudConfig(depth_max=1000.0)
    halo = 32
    scenes = [layered_scene(H, W, max_disp=sz.max_disp, background_disp=16,
                            layers=6, seed=args.seed + i) for i in range(4)]
    L = np.stack([s.left for s in scenes]).astype(np.float32)
    R = np.stack([s.right for s in scenes]).astype(np.float32)

    with sgm_backend(kernel_backend):
        step_1 = make_sharded_pipeline_step(rig, cfg, cloud, make_mesh(1, 1),
                                            halo=halo)
        ref = [step_1(L[i:i + 1], R[i:i + 1]) for i in range(4)]
        ref_d = np.concatenate([np.asarray(o["disparity"]) for o in ref])
        ref_v = np.concatenate([np.asarray(o["valid"]) for o in ref])
        for i in range(4):
            err = scene_error(ref_d[i], ref_v[i], scenes[i])
            log(f"[four] 1x1 frame {i}: median_abs_err_px="
                f"{err['median_abs_err_px']:.4f} density={err['density']:.4f}")

        for (nd, ns), frames in (((4, 1), slice(0, 4)), ((1, 4), slice(0, 1))):
            step = make_sharded_pipeline_step(rig, cfg, cloud,
                                              make_mesh(nd, ns), halo=halo)
            t0 = time.perf_counter()
            out = jax.block_until_ready(step(L[frames], R[frames]))
            first_s = time.perf_counter() - t0
            cuts = [H * k // ns for k in range(1, ns)]
            a = sharded_agreement(out["disparity"], out["valid"],
                                  ref_d[frames], ref_v[frames], cuts,
                                  margin=halo)
            log(f"[four] mesh {nd}x{ns} {W}x{H} frames={frames.stop} "
                f"halo={halo} cuts={cuts}: agreement={a['agreement']:.6f} "
                f"compared_share={a['compared_share']:.4f} "
                f"first_call_s={first_s:.3f}")
            check(a["compared_share"] > 0.3, "comparison is vacuous")
            check(a["agreement"] > SHARDED_GATE,
                  f"mesh {nd}x{ns}: agreement {a['agreement']}")


# ---------------------------------------------------------------- main ---

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic scenes and cost volumes")
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on four devices")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes, kernel in the Pallas interpreter; "
                         "never reports ok")
    ap.add_argument("--no-gpu-check", action="store_true",
                    help="skip the GPU check (only with --rehearse)")
    args = ap.parse_args(argv)
    if args.no_gpu_check and not args.rehearse:
        ap.error("--no-gpu-check is only accepted with --rehearse")

    sz = Sizes(args.rehearse)
    kernel_backend = "triton_interpret" if args.rehearse else "triton"
    devs = phase_device(args)
    if args.four:
        phase_four(args, sz, kernel_backend)
    else:
        phase_kernel(args, sz)
        phase_flagship(args, sz, kernel_backend)
        phase_matchers(args, sz, kernel_backend)

    if args.rehearse:
        log("[rehearsal] all phases passed; a rehearsal reports no result")
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
