"""The six matcher backends, keyed by the reference's algorithm enum.

Reference backends (include/stereoMatcher/*.h) -> JAX equivalents:

| enum | reference                          | here                                |
|------|------------------------------------|-------------------------------------|
| 0    | MatcherOpenCVBlock (cv::StereoBM)  | bm_match — SAD block matching       |
| 1    | MatcherOpenCVSGBM (cv::StereoSGBM) | sgbm_match — BT + 8/5-path SGM      |
| 2    | MatcherI3DRSGM (Phobos engine)     | i3drsgm_match — census pyramid SGM  |
| 3    | MatcherOpenCVBlockCuda             | bm_match (device-resident anyway)   |
| 4    | MatcherOpenCVBPCuda                | bp_match — hierarchical min-sum BP  |
| 5    | MatcherOpenCVCSBPCuda              | csbp_match — coarse-to-fine BP      |

All are pure jittable functions (H, W)|(B, H, W) float32 -> MatchResult.
There is no "CPU vs CUDA" split: enum 0 and 3 share one implementation,
which XLA compiles for whichever device runs it.
"""

from __future__ import annotations

import jax

from i3dr_stereo_tpu.config.params import Algorithm, CostFunction, MatcherConfig
from i3dr_stereo_tpu.matchers.base import MatchResult
from i3dr_stereo_tpu.ops import (
    box_aggregate,
    bt_cost_volume,
    census_cost_volume,
    census_transform,
    lr_consistency,
    sad_cost_volume,
    speckle_filter,
    wta_disparity,
    xsobel_prefilter,
)
from i3dr_stereo_tpu.ops.cost import texture_response
from i3dr_stereo_tpu.ops.median import median3x3_masked
from i3dr_stereo_tpu.ops.sgm import DIRECTIONS_4, DIRECTIONS_5, DIRECTIONS_8
from i3dr_stereo_tpu.ops.sgm_dispatch import sgm_aggregate_auto as sgm_aggregate
from i3dr_stereo_tpu.ops.lr_check import right_cost_volume
from i3dr_stereo_tpu.ops.wls import wls_fill, wls_fill_lr


def _interp_backward_wls(disp, valid, S, cfg: MatcherConfig, left):
    """The reference's full interp path: a right-anchored backward match
    feeding LR-confidence-weighted WLS (matcherOpenCVBlock.cpp:22-33:
    forwardMatch + backwardMatch -> DisparityWLSFilter lambda=8000
    sigma=1.5). The backward match is derived from the already-aggregated
    volume (createRightMatcher trick) — no second match pass."""
    SR = right_cost_volume(S, cfg.min_disparity)
    disp_r, ok_r = wta_disparity(SR, cfg.min_disparity, uniqueness_ratio=0.0,
                                 subpixel=cfg.subpixel)
    return wls_fill_lr(disp, valid, disp_r, ok_r, left)


def _batched(img: jax.Array) -> tuple[jax.Array, bool]:
    return (img, True) if img.ndim == 3 else (img[None], False)


def _unbatch(res: MatchResult, batched: bool) -> MatchResult:
    if batched:
        return res
    return MatchResult(disparity=res.disparity[0], valid=res.valid[0])


def _directions(cfg: MatcherConfig):
    return {4: DIRECTIONS_4, 5: DIRECTIONS_5, 8: DIRECTIONS_8}[cfg.num_directions]


def _cost_volume(left, right, cfg: MatcherConfig):
    """Pixel costs by configured cost function, pre-aggregation."""
    if cfg.cost == CostFunction.CENSUS:
        cl = census_transform(left, cfg.census_height, cfg.census_width)
        cr = census_transform(right, cfg.census_height, cfg.census_width)
        return census_cost_volume(cl, cr, cfg.min_disparity, cfg.disparity_range)
    if cfg.cost == CostFunction.BT:
        lf = xsobel_prefilter(left, cfg.prefilter_cap)
        rf = xsobel_prefilter(right, cfg.prefilter_cap)
        return bt_cost_volume(lf, rf, cfg.min_disparity, cfg.disparity_range)
    lf = xsobel_prefilter(left, cfg.prefilter_cap)
    rf = xsobel_prefilter(right, cfg.prefilter_cap)
    return sad_cost_volume(lf, rf, cfg.min_disparity, cfg.disparity_range)


def _postprocess(disp, valid, S, cfg: MatcherConfig, left, st=None):
    """Shared post-match chain: LR check, speckle, median, hole fill.

    ``st`` is the STATIC shadow of cfg for structural gating: cfg's
    numeric fields may be traced scalars under live reconfigure
    (StereoPipeline passes both), and tracers cannot drive python
    control flow. Direct callers leave st=None (cfg is plain)."""
    st = st or cfg
    if st.disp12_max_diff >= 0 and st.algorithm != Algorithm.BM:
        disp, valid = lr_consistency(disp, valid, S, cfg.min_disparity,
                                     cfg.disp12_max_diff if st.disp12_max_diff > 0 else 1.0)
    if st.speckle_size > 0:
        valid = speckle_filter(disp, valid, max_size=cfg.speckle_size,
                               max_diff=cfg.speckle_range,
                               downsample=cfg.speckle_downsample)
    if cfg.median_filter:
        disp = median3x3_masked(disp, valid)
    if cfg.interp:
        disp, valid = _interp_backward_wls(disp, valid, S, cfg, left)
    elif cfg.interpolate_missing:
        disp, valid = wls_fill(disp, valid, left)
    return disp, valid


def bm_match(left, right, cfg: MatcherConfig, st=None) -> MatchResult:
    """Block matching (cv::StereoBM semantics, matcherOpenCVBlock.cpp):
    x-Sobel prefilter, SAD over the correlation window, WTA with
    texture + uniqueness checks, speckle filter, x16-grade subpixel."""
    st = st or cfg
    l, batched = _batched(left)
    r = right if right.ndim == 3 else right[None]
    if cfg.prefilter_type == "normalized_response":
        from i3dr_stereo_tpu.ops.cost import normalized_response_prefilter

        pref_l = normalized_response_prefilter(l, cfg.prefilter_size,
                                               cfg.prefilter_cap)
        pref_r = normalized_response_prefilter(r, cfg.prefilter_size,
                                               cfg.prefilter_cap)
    else:
        pref_l = xsobel_prefilter(l, cfg.prefilter_cap)
        pref_r = xsobel_prefilter(r, cfg.prefilter_cap)
    C, valid_cv = sad_cost_volume(pref_l, pref_r, cfg.min_disparity, cfg.disparity_range)
    S = box_aggregate(C, valid_cv, cfg.window_size)
    disp, valid = wta_disparity(S, cfg.min_disparity,
                                uniqueness_ratio=cfg.uniqueness_ratio,
                                subpixel=cfg.subpixel)
    if st.texture_threshold > 0:
        tex = texture_response(pref_l, cfg.window_size, cfg.prefilter_cap)
        valid = valid & (tex >= cfg.texture_threshold * cfg.window_size)
    if st.speckle_size > 0:
        valid = speckle_filter(disp, valid, max_size=cfg.speckle_size,
                               max_diff=cfg.speckle_range,
                               downsample=cfg.speckle_downsample)
    if cfg.interp:
        disp, valid = _interp_backward_wls(disp, valid, S, cfg, l)
    elif cfg.interpolate_missing:
        disp, valid = wls_fill(disp, valid, l)
    return _unbatch(MatchResult(disparity=disp, valid=valid), batched)


def sgbm_match(left, right, cfg: MatcherConfig, st=None) -> MatchResult:
    """Semi-global block matching (cv::StereoSGBM semantics,
    matcherOpenCVSGBM.cpp): BT costs on the prefiltered pair, block sum,
    N-path aggregation, uniqueness + LR + speckle, parabolic subpixel.
    ``fullDP``/num_directions=8 corresponds to MODE_HH."""
    st = st or cfg
    l, batched = _batched(left)
    r = right if right.ndim == 3 else right[None]

    C, valid_cv = _cost_volume(l, r, cfg)
    C = box_aggregate(C, valid_cv, cfg.window_size)
    S = sgm_aggregate(C, cfg.p1, cfg.p2, _directions(cfg))
    disp, valid = wta_disparity(S, cfg.min_disparity,
                                uniqueness_ratio=cfg.uniqueness_ratio,
                                subpixel=cfg.subpixel)
    disp, valid = _postprocess(disp, valid, S, cfg, l, st)
    return _unbatch(MatchResult(disparity=disp, valid=valid), batched)


def i3drsgm_match(left, right, cfg: MatcherConfig, st=None) -> MatchResult:
    """Census SGM with the Phobos-profile feature set
    (ini/quick.param): census window, 4 path directions with additive
    penalties, backmatching check, speckle(0.5, 100), median 3x3.
    With cfg.pyramid the coarse-to-fine schedule of
    :mod:`i3dr_stereo_tpu.matchers.pyramid` runs instead."""
    st = st or cfg
    if st.pyramid:
        from i3dr_stereo_tpu.matchers.pyramid import pyramid_sgm_match
        return pyramid_sgm_match(left, right, cfg, st=st)
    l, batched = _batched(left)
    r = right if right.ndim == 3 else right[None]
    C, valid_cv = _cost_volume(l, r, cfg)
    S = sgm_aggregate(C, cfg.p1, cfg.p2, _directions(cfg))
    disp, valid = wta_disparity(S, cfg.min_disparity,
                                uniqueness_ratio=cfg.uniqueness_ratio,
                                subpixel=cfg.subpixel)
    if st.backmatch_distance >= 0:
        disp, valid = lr_consistency(disp, valid, S, cfg.min_disparity,
                                     cfg.backmatch_distance)
    if st.speckle_size > 0:
        valid = speckle_filter(disp, valid, max_size=cfg.speckle_size,
                               max_diff=cfg.speckle_range,
                               downsample=cfg.speckle_downsample)
    if cfg.median_filter:
        disp = median3x3_masked(disp, valid)
    if cfg.interp or cfg.interpolate_missing:
        disp, valid = wls_fill(disp, valid, l)
    return _unbatch(MatchResult(disparity=disp, valid=valid), batched)


def bp_match(left, right, cfg: MatcherConfig, st=None) -> MatchResult:
    """Hierarchical min-sum belief propagation
    (cv::cuda::StereoBeliefPropagation analog, matcherOpenCVBPCuda.cpp)."""
    from i3dr_stereo_tpu.matchers.bp import belief_propagation_match
    return belief_propagation_match(left, right, cfg, constant_space=False,
                                    st=st)


def csbp_match(left, right, cfg: MatcherConfig, st=None) -> MatchResult:
    """Constant-space BP (cv::cuda::StereoConstantSpaceBP analog,
    matcherOpenCVCSBPCuda.cpp): coarse-to-fine with a shrinking
    per-level disparity candidate set."""
    from i3dr_stereo_tpu.matchers.bp import belief_propagation_match
    return belief_propagation_match(left, right, cfg, constant_space=True,
                                    st=st)


MATCHER_REGISTRY = {
    Algorithm.BM: bm_match,
    Algorithm.SGBM: sgbm_match,
    Algorithm.I3DRSGM: i3drsgm_match,
    Algorithm.BM_GPU: bm_match,
    Algorithm.BP_GPU: bp_match,
    Algorithm.CSBP_GPU: csbp_match,
}


def compute_disparity(left, right, cfg: MatcherConfig) -> MatchResult:
    """Pure functional entry: dispatch on cfg.algorithm."""
    return MATCHER_REGISTRY[cfg.algorithm](left, right, cfg.sanitize())
