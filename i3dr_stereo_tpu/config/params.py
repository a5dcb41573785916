"""Unified typed configuration.

The reference spreads configuration over three mechanisms that must stay
in sync by hand: per-node rosparam blocks (launch/stereo_matcher.launch:20-108),
a dynamic_reconfigure schema (cfg/i3DR_Disparity.cfg:11-39) and the I3DRSGM
INI profiles (ini/quick.param) mutated by textual find/replace
(I3DRSGM.cpp:40-140). Here all of it is one frozen dataclass; "live
reconfigure" is `dataclasses.replace` + re-jit only when a *shape-affecting*
field changed (cf. the reference's full engine rebuild per setter,
I3DRSGM.cpp:630-654).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Algorithm(enum.IntEnum):
    """Matcher backend ids, numerically identical to the reference enum
    (cfg/i3DR_Disparity.cfg:11-19) so launch-profile configs port 1:1."""

    BM = 0            # "StereoBM"      — block matching
    SGBM = 1          # "StereoSGBM"    — semi-global block matching
    I3DRSGM = 2       # "StereoI3DRSGM" — pyramid census SGM (quick/subpix profile)
    BM_GPU = 3        # "StereoBMGPU"   — device block matching (same code as BM)
    BP_GPU = 4        # "StereoBPGPU"   — belief propagation
    CSBP_GPU = 5      # "StereoCSBPGPU" — constant-space belief propagation


class CostFunction(enum.Enum):
    SAD = "sad"          # plain absolute difference (BM family)
    BT = "bt"            # Birchfield–Tomasi sampling-insensitive (SGBM)
    CENSUS = "census"    # hamming over census transform (I3DRSGM family)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Every parameter of the reference's matcher surface, normalized.

    Field-by-field parity with cfg/i3DR_Disparity.cfg:21-39 plus the
    I3DRSGM-only knobs (per-direction penalties, census window, pyramid,
    backmatching threshold) from I3DRSGM.cpp:294-508 / ini/quick.param —
    expressed in natural units (pixels, cost units), with the reference's
    INI unit quirks (÷1000 penalties, ÷10 range, ÷20 shift) handled in
    :func:`i3dr_stereo_tpu.config.profile.from_ros_convention`.
    """

    algorithm: Algorithm = Algorithm.BM

    # --- search geometry (shape-affecting: changing these re-jits) ----------
    min_disparity: int = 0            # cfg "min_disparity"
    disparity_range: int = 64         # cfg "disparity_range" (rounded to x16)
    window_size: int = 15             # cfg "correlation_window_size" (odd)
    downsample_scale: float = 1.0     # abstractStereoMatcher.cpp:9-30 cubic resize

    # --- prefilter (BM/SGBM) ------------------------------------------------
    prefilter_size: int = 9           # cfg "prefilter_size" (normalized-response window)
    prefilter_cap: int = 31           # cfg "prefilter_cap" (clip bound)
    # cv::StereoBM prefilter mode: "xsobel" (default) or
    # "normalized_response" (consumes prefilter_size;
    # matcherOpenCVBlock.cpp:86-108 setter surface)
    prefilter_type: str = "xsobel"

    # --- smoothness (SGM family) --------------------------------------------
    p1: float = 200.0                 # cfg "p1"
    p2: float = 400.0                 # cfg "p2"
    num_directions: int = 8           # 4/5/8 SGM paths (quick.param:144-147 uses 4)

    # --- post-filtering ------------------------------------------------------
    uniqueness_ratio: float = 15.0    # cfg "uniqueness_ratio" (%)
    texture_threshold: float = 10.0   # cfg "texture_threshold" (BM only)
    speckle_size: int = 100           # cfg "speckle_size" (max region px)
    speckle_range: float = 4.0        # cfg "speckle_range" (max intra-region diff)
    speckle_downsample: int = 1       # >1: label on a strided subsample
                                      # (engine-style per-scale filtering)
    disp12_max_diff: float = 0.0      # cfg "disp12MaxDiff"; <0 disables LR check
    subpixel: bool = True             # parabolic DSI interp (quick.param "DSI Interpolator")
    median_filter: bool = False       # 3x3 median optimizer (quick.param:89-90)
    interp: bool = False              # cfg "interp": backward match + WLS hole fill
    occlusion_detection: bool = False # I3DRSGM.cpp:566-595
    occlusion_interp: bool = False    # I3DRSGM.cpp:597-628

    # --- census / pyramid (I3DRSGM family) ----------------------------------
    cost: CostFunction = CostFunction.SAD
    census_width: int = 9             # "Feature Set Size X" (quick.param:105)
    census_height: int = 9            # "Feature Set Size Y" (quick.param:106)
    pyramid: bool = False             # I3DRSGM.cpp:405-440 enable pyramid
    max_pyramid_level: int = 6        # I3DRSGM.cpp:442-469 ("maxPyramid")
    backmatch_distance: float = 1.5   # "Maximum Backmatching Distance" (quick.param:122)

    # --- belief propagation (BP/CSBP family) --------------------------------
    bp_iters: int = 5                 # cv::cuda BP defaults: 5 iters, 5 levels
    bp_levels: int = 5
    bp_msg_cost: float = 25.0         # data cost truncation analog
    csbp_planes: int = 4              # cv::cuda CSBP nr_plane: candidate
                                      # disparities kept per pixel at the
                                      # finest level (constant-space trick)

    # --- engine --------------------------------------------------------------
    interpolate_missing: bool = False # fill invalid by neighbourhood (Gauss interp)
    fixed_point_scale: int = 16       # DPP: disparity stored x16 (generate_disparity.cpp:402-436)

    def sanitize(self) -> "MatcherConfig":
        """Apply the reference's constraint fixups
        (generate_disparity.cpp:759-775): odd window, range multiple of 16,
        I3DRSGM census window <= 17 and odd."""
        if self.prefilter_type not in ("xsobel", "normalized_response"):
            raise ValueError(
                f"prefilter_type {self.prefilter_type!r}: expected 'xsobel' "
                "or 'normalized_response' (cv::StereoBM's two modes)")
        window = int(self.window_size)
        if window % 2 == 0:
            window += 1
        rng = max(16, _round_up(int(self.disparity_range), 16))
        census_w, census_h = int(self.census_width), int(self.census_height)
        if self.algorithm == Algorithm.I3DRSGM:
            census_w = min(census_w, 17)
            census_h = min(census_h, 17)
            if census_w % 2 == 0:
                census_w += 1
            if census_h % 2 == 0:
                census_h += 1
        return dataclasses.replace(
            self,
            window_size=window,
            disparity_range=rng,
            census_width=census_w,
            census_height=census_h,
        )

    # Shape-affecting fields: a change to any of these requires re-tracing
    # the jitted pipeline; anything else is a cheap closure constant rebake.
    SHAPE_FIELDS = (
        "algorithm", "min_disparity", "disparity_range", "window_size",
        "downsample_scale", "num_directions", "cost", "census_width",
        "census_height", "pyramid", "max_pyramid_level", "bp_iters",
        "bp_levels", "csbp_planes",
    )

    def shape_key(self) -> tuple:
        return tuple(getattr(self, f) for f in self.SHAPE_FIELDS)

    def replace(self, **kw) -> "MatcherConfig":
        return dataclasses.replace(self, **kw).sanitize()


@dataclasses.dataclass(frozen=True)
class PointCloudConfig:
    """cfg/i3DR_pointCloud.cfg — depth clamp + PLY output mode."""

    depth_max: float = 10.0
    depth_min: float = 0.0
    save_points_as_binary: bool = False


@dataclasses.dataclass(frozen=True)
class CameraSettings:
    """cfg/tiscamera_settings.cfg — capture property schema."""

    brightness: int = 0        # 0..4095
    exposure: int = 6000       # 20..100000 (us)
    gain: int = 0              # 0..480
    exposure_auto: bool = False
    gain_auto: bool = False

    def clamp(self) -> "CameraSettings":
        return dataclasses.replace(
            self,
            brightness=min(max(self.brightness, 0), 4095),
            exposure=min(max(self.exposure, 20), 100000),
            gain=min(max(self.gain, 0), 480),
        )


def _bm(**kw) -> MatcherConfig:
    return MatcherConfig(**kw).sanitize()


# Per-algorithm default parameter blocks, mirroring the launch-file defaults
# (launch/stereo_matcher.launch:20-108). Keys match the reference enum.
ALGORITHM_DEFAULTS = {
    Algorithm.BM: _bm(
        algorithm=Algorithm.BM, cost=CostFunction.SAD, window_size=9,
        disparity_range=64, texture_threshold=10.0, uniqueness_ratio=15.0,
    ),
    Algorithm.SGBM: _bm(
        algorithm=Algorithm.SGBM, cost=CostFunction.BT, window_size=9,
        disparity_range=64, p1=200.0, p2=400.0, uniqueness_ratio=15.0,
        num_directions=8,
    ),
    Algorithm.I3DRSGM: _bm(
        algorithm=Algorithm.I3DRSGM, cost=CostFunction.CENSUS,
        census_width=9, census_height=9, disparity_range=64, p1=0.1, p2=0.8,
        num_directions=4, pyramid=True, max_pyramid_level=6, subpixel=True,
        backmatch_distance=1.5, speckle_range=0.5, speckle_size=100,
        median_filter=True,
        # the Phobos engine has no WTA margin filter (quick.param has no
        # uniqueness key) — 0 disables it; setting it in MatcherConfig
        # now genuinely applies it at every pyramid level
        uniqueness_ratio=0.0,
    ),
    Algorithm.BM_GPU: _bm(
        algorithm=Algorithm.BM_GPU, cost=CostFunction.SAD, window_size=9,
        disparity_range=64,
    ),
    Algorithm.BP_GPU: _bm(
        algorithm=Algorithm.BP_GPU, cost=CostFunction.SAD, window_size=1,
        disparity_range=64, bp_iters=5, bp_levels=5,
    ),
    Algorithm.CSBP_GPU: _bm(
        algorithm=Algorithm.CSBP_GPU, cost=CostFunction.SAD, window_size=1,
        disparity_range=64, bp_iters=8, bp_levels=4,
    ),
}
