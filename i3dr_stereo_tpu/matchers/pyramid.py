"""Coarse-to-fine pyramid SGM — the JAX re-design of the licensed
I3DRSGM/Phobos engine's schedule (ini/quick.param):

    6 pyramid levels, census 9x9 features, only ~31 disparities searched
    per level ("Number Of Disparities = 31"), each finer level predicted
    from the coarser result ("Predictor = Shift"), coarsest level offset
    by "Top Prediction Shift", optional half-pel subpix refinement
    passes ("Disparity Step Size = 0.5", subpix.param).

This schedule is why the reference engine is real-time at 2448x2048 with
a >500 px disparity range: the per-level search stays narrow, so the
cost volume is ~D/8 the size of a brute-force SGBM volume. Each level is
a jitted census + 4-path SGM over a *per-pixel shifted* search window:

    C_l(y, x, k) = hamming( cl(y, x), cr(y, x - (pred(y,x) + k)) )

with the prediction median-smoothed first so neighbouring pixels share
window alignment (the SGM recurrence then treats equal k as equal
disparity; exact at smooth predictions, off only across prediction
discontinuities — the same approximation the shift-predictor engine
makes). The whole pyramid is one jit; every level's tensors stay on the
device. The schedule itself is data: an
:class:`~i3dr_stereo_tpu.config.profile.SGMProfile` (parsed from the
reference's .param INI files or built from the MatcherConfig).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from i3dr_stereo_tpu.config.params import MatcherConfig
from i3dr_stereo_tpu.config.profile import PyramidLevelConfig, SGMProfile
from i3dr_stereo_tpu.matchers.base import MatchResult
from i3dr_stereo_tpu.ops.census import census_transform
from i3dr_stereo_tpu.ops.median import median3x3, median3x3_masked
from i3dr_stereo_tpu.ops.occlusion import detect_occlusions, fill_occlusions
from i3dr_stereo_tpu.ops.sgm import DIRECTIONS_4, DIRECTIONS_8
from i3dr_stereo_tpu.ops.sgm_dispatch import sgm_aggregate_auto as sgm_aggregate
from i3dr_stereo_tpu.ops.speckle import speckle_filter
from i3dr_stereo_tpu.ops.subpix import halfpel_refine
from i3dr_stereo_tpu.ops.wls import wls_fill
from i3dr_stereo_tpu.ops.wta import wta_disparity

BIG = 1.0e9


def _downsample2(img: jax.Array) -> jax.Array:
    """2x2 area downsample of (B, H, W): a pair-sum along x, then along y."""
    B, H, W = img.shape
    H2, W2 = H // 2 * 2, W // 2 * 2
    x = img[:, :H2, :W2]
    x = x.reshape(B, H2, W2 // 2, 2).sum(-1)      # column pairs
    x = x.reshape(B, H2 // 2, 2, W2 // 2).sum(2)  # row pairs
    return x * 0.25


def _upsample2_disp(d: jax.Array, H: int, W: int) -> jax.Array:
    """Upsample a disparity map to (H, W) and double its values."""
    return 2.0 * jax.image.resize(d, d.shape[:-2] + (H, W), method="nearest")


def shifted_census_cost(cl: jax.Array, cr: jax.Array, offset: jax.Array,
                        K: int) -> tuple[jax.Array, jax.Array]:
    """Census hamming cost over a per-pixel disparity window.

    cl/cr: (B, H, W, nw) packed census. offset: (B, H, W) int32 — the
    window's base disparity (window spans offset .. offset+K-1).
    Returns (C: (B,H,W,K) float32 with BIG where the window leaves the
    image, valid).
    """
    B, H, W, nw = cl.shape
    xs = jnp.arange(W, dtype=jnp.int32)[None, None, :]
    k = jnp.arange(K, dtype=jnp.int32)
    src = xs[..., None] - (offset[..., None] + k)           # (B,H,W,K)
    valid = (src >= 0) & (src < W)
    src_c = jnp.clip(src, 0, W - 1)
    crg = jnp.take_along_axis(cr[:, :, :, None, :], src_c[..., None], axis=2)
    x = jnp.bitwise_xor(cl[:, :, :, None, :], crg)
    ham = jnp.sum(jax.lax.population_count(x), axis=-1)
    C = jnp.where(valid, ham.astype(jnp.float32), BIG)
    return C, valid


def profile_from_config(cfg: MatcherConfig, st=None) -> SGMProfile:
    """Build a pyramid schedule from the flat MatcherConfig (the path
    used when no .param profile was loaded): quick-profile shape with the
    config's census/penalty/filter values on every level.

    ``st`` is the static shadow of cfg for structural gating (cfg's
    numeric fields may be traced scalars under live reconfigure)."""
    st = st or cfg
    n = max(1, int(cfg.max_pyramid_level))
    levels = []
    for lv in range(n - 1, -1, -1):
        levels.append(PyramidLevelConfig(
            level=lv,
            enabled=True,
            subpix_pass=False,
            num_disparities=31,
            census_w=cfg.census_width,
            census_h=cfg.census_height,
            p1=(cfg.p1,) * 4,
            p2=(cfg.p2,) * 4,
            backmatch=st.backmatch_distance >= 0,
            backmatch_dist=(cfg.backmatch_distance
                            if st.backmatch_distance >= 0 else 0.0),
            median=cfg.median_filter,
            # speckle only on the finest level: intermediate levels
            # median-fill invalid pixels anyway, so per-level speckle
            # re-kills the same blobs at ~4x the cost (per-level control
            # stays available through .param profiles)
            speckle=st.speckle_size > 0 and lv == 0,
            speckle_max_diff=cfg.speckle_range,
            speckle_max_region=cfg.speckle_size,
            subpixel=cfg.subpixel,
            interpolate_gaps=cfg.interp or cfg.interpolate_missing,
            interpolate_occlusions=cfg.occlusion_interp,
            occlusion_detection=cfg.occlusion_detection,
            prediction_shift=0.0,
            uniqueness_ratio=cfg.uniqueness_ratio,
            # the flat config's interp knob means the cv-style WLS chain
            # (cfg/i3DR_Disparity.cfg:38); interpolate_missing is the
            # engine's neighbourhood fill ("Interpolator Mode = Gauss",
            # quick.param:111-117); engine .param profiles carry their
            # own mode
            interpolator_mode="wls" if cfg.interp else "gauss",
        ))
    return SGMProfile(name="from_config", levels=tuple(levels))


def pyramid_sgm_match(left, right, cfg: MatcherConfig,
                      profile: Optional[SGMProfile] = None,
                      st=None) -> MatchResult:
    """Full coarse-to-fine match driven by a typed SGMProfile."""
    if profile is None:
        profile = profile_from_config(cfg, st)
    batched = left.ndim == 3
    l = (left if batched else left[None]).astype(jnp.float32)
    r = (right if batched else right[None]).astype(jnp.float32)
    B, H, W = l.shape

    passes = profile.enabled_levels
    if not passes:
        raise ValueError("profile has no enabled pyramid levels")
    # clamp levels to what the image size supports (coarsest >= ~32 px)
    max_by_size = max(0, min(H, W).bit_length() - 6)
    passes = [dataclasses.replace(p, level=min(p.level, max_by_size))
              for p in passes]
    deepest = max(p.level for p in passes)

    # image pyramids, fine -> coarse
    pyr_l, pyr_r = [l], [r]
    for _ in range(deepest):
        pyr_l.append(_downsample2(pyr_l[-1]))
        pyr_r.append(_downsample2(pyr_r[-1]))

    dirs = DIRECTIONS_4 if cfg.num_directions == 4 else DIRECTIONS_8

    disp = None        # current estimate at `cur_level` resolution
    valid = None
    cur_level = None

    for p in passes:
        ll, rr = pyr_l[p.level], pyr_r[p.level]
        Bh, Hh, Wh = ll.shape

        if p.subpix_pass:
            if disp is None:
                continue
            if cur_level != p.level:
                disp = _upsample2_disp(disp, Hh, Wh)
                cur_level = p.level
                valid = None
            disp = halfpel_refine(ll, rr, disp,
                                  jnp.ones(disp.shape, bool),
                                  step_size=p.step_size)
            continue

        K = max(8, p.num_disparities + 1)  # odd profile count -> even window
        pens = tuple((p.p1[min(i, 3)], p.p2[min(i, 3)])
                     for i in range(len(dirs)))

        if disp is None:
            base_val = int(round(cfg.min_disparity / (2 ** p.level)
                                 + p.prediction_shift))
            offset = jnp.full((Bh, Hh, Wh), base_val, jnp.int32)
        else:
            pred = disp
            while cur_level > p.level:
                pred = _upsample2_disp(pred, pyr_l[cur_level - 1].shape[1],
                                       pyr_l[cur_level - 1].shape[2])
                cur_level -= 1
            pred = median3x3(pred)  # align neighbouring windows
            pred_int = jnp.round(pred).astype(jnp.int32)
            pred_int = jnp.clip(pred_int, 0, Wh - 1)
            offset = pred_int - K // 2

        cl = census_transform(ll, p.census_h, p.census_w)
        cr = census_transform(rr, p.census_h, p.census_w)
        C, _ = shifted_census_cost(cl, cr, offset, K)
        S = sgm_aggregate(C, directions=dirs, per_direction_penalties=pens)
        finest = p.level == 0
        dk, ok = wta_disparity(S, 0, uniqueness_ratio=p.uniqueness_ratio,
                               subpixel=(finest and p.subpixel))
        disp = dk + offset.astype(jnp.float32)
        cur_level = p.level
        valid = ok & (jnp.min(C, axis=-1) < BIG / 2)
        # matched right column must land inside the image
        xs_v = jnp.arange(Wh, dtype=jnp.int32)[None, None, :]
        rcol = xs_v - jnp.round(disp).astype(jnp.int32)
        valid = valid & (rcol >= 0) & (rcol < Wh)

        if p.backmatch:
            disp, valid = _roundtrip_check(disp, valid, p.backmatch_dist)
        if p.speckle and p.speckle_max_region > 0:
            valid = speckle_filter(disp, valid,
                                   max_size=p.speckle_max_region,
                                   max_diff=p.speckle_max_diff,
                                   downsample=cfg.speckle_downsample)
        if p.occlusion_detection:
            occ = detect_occlusions(disp, valid)
            if p.interpolate_occlusions:
                disp, valid = fill_occlusions(disp, valid, occ)
            else:
                valid = valid & ~occ
        if p.median:
            disp = median3x3_masked(disp, valid)
        if not finest:
            # between levels: invalid pixels inherit the local median so
            # the next level's windows re-centre sensibly
            disp = jnp.where(valid, disp, median3x3(disp))
        elif p.interpolate_gaps:
            disp, valid = _fill_gaps(p, disp, valid, ll)

    # bring the final estimate to full resolution if the finest enabled
    # level was coarser than 0 (reference: disabled fine pyramids)
    while cur_level > 0:
        disp = _upsample2_disp(disp, pyr_l[cur_level - 1].shape[1],
                               pyr_l[cur_level - 1].shape[2])
        valid = jax.image.resize(valid.astype(jnp.float32),
                                 disp.shape, method="nearest") > 0.5
        cur_level -= 1

    res = MatchResult(disparity=disp, valid=valid)
    if not batched:
        res = MatchResult(disparity=res.disparity[0], valid=res.valid[0])
    return res


def _fill_gaps(p, disp, valid, ll):
    """Hole filling per the level's "Interpolator Mode": the engine's
    32-direction Gauss interpolator (quick.param:111-117) or the
    cv-style WLS diffusion used by the flat-config interp path."""
    if p.interpolator_mode == "gauss":
        from i3dr_stereo_tpu.ops.gauss_interp import gauss_interpolate

        return gauss_interpolate(disp, valid,
                                 n_directions=p.interp_directions,
                                 min_elements=p.interp_min_elements)
    return wls_fill(disp, valid, ll)


def _roundtrip_check(disp: jax.Array, valid: jax.Array, max_diff):
    """Backmatching on the absolute map via an exact forward-splat right
    map (the engine's "Compute Backmatching", quick.param).

    The right view's disparity at column xr is the MAX disparity of any
    left pixel landing there (nearest surface wins the z-buffer — a
    scatter-max splat). Pixel x is consistent iff the surface visible at
    its right column is its own: |d_R(x - round(d)) - d(x)| <= max_diff.

    The previous form compared d(x) against d(x - round(d)) on the LEFT
    map — a fronto-parallel approximation that mass-kills slanted
    surfaces (error ~ d * |∇d|: a 2448-wide plane spanning 160 px of
    disparity loses every pixel with d > ~25). The splat is exact for
    any geometry: x itself always claims its right column, so only a
    genuinely nearer surface (true occlusion) can evict it."""
    B, H, W = disp.shape
    d_int = jnp.round(disp).astype(jnp.int32)
    xr = jnp.arange(W, dtype=jnp.int32)[None, None, :] - d_int
    in_img = (xr >= 0) & (xr < W)
    xr_c = jnp.clip(xr, 0, W - 1)
    src = jnp.where(valid & in_img, disp, -1.0e9)
    bi = jax.lax.broadcasted_iota(jnp.int32, (B, H, W), 0)
    yi = jax.lax.broadcasted_iota(jnp.int32, (B, H, W), 1)
    d_right = jnp.full((B, H, W), -1.0e9, disp.dtype)
    d_right = d_right.at[bi, yi, xr_c].max(src)
    d_at_xr = jnp.take_along_axis(d_right, xr_c, axis=2)
    consistent = jnp.abs(d_at_xr - disp) <= max_diff
    return disp, valid & in_img & consistent
