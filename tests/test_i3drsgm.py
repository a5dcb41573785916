"""I3DRSGM engine facade: wrapper surface + profile-driven pyramid."""

import numpy as np
import pytest

from i3dr_stereo_tpu.config.profile import quick_profile, subpix_profile
from i3dr_stereo_tpu.io.synthetic import layered_scene
from i3dr_stereo_tpu.matchers.i3drsgm import I3DRSGM
from i3dr_stereo_tpu.matchers.pyramid import pyramid_sgm_match
from i3dr_stereo_tpu.config.params import ALGORITHM_DEFAULTS, Algorithm
from i3dr_stereo_tpu.ops.occlusion import detect_occlusions, fill_occlusions
from i3dr_stereo_tpu.ops.subpix import halfpel_refine

import jax.numpy as jnp


def _scene():
    return layered_scene(96, 128, max_disp=20, seed=4)


def test_engine_matches_scene():
    sc = _scene()
    eng = I3DRSGM()
    res = eng.forward_match(sc.left, sc.right)
    d = np.asarray(res.disparity)
    v = np.asarray(res.valid) & sc.valid
    assert v.mean() > 0.5
    assert np.median(np.abs(d - sc.disparity)[v]) < 0.5


def test_engine_setters_apply_unit_quirks():
    eng = I3DRSGM()
    eng.setP1(100.0)
    eng.setP2(800.0)
    eng.setDisparityRange(520)
    eng.setSpeckleDifference(5.0)
    eng.setMinDisparity(400.0)
    eng.setWindowSize(20)
    lv = eng.profile.levels[0]
    assert lv.p1 == (0.1,) * 4
    assert lv.p2 == (0.8,) * 4
    assert lv.num_disparities == 53      # 520/10 forced odd
    assert lv.speckle_max_diff == 0.5
    assert lv.census_w == 17             # clamped <=17, odd
    coarse = max(l.level for l in eng.profile.levels)
    assert [l.prediction_shift for l in eng.profile.levels
            if l.level == coarse][0] == 20.0


def test_engine_pyramid_enable():
    eng = I3DRSGM()
    eng.maxPyramid(2)
    mains = [l for l in eng.profile.levels if not l.subpix_pass]
    assert all(l.enabled == (l.level <= 2) for l in mains)


def test_reference_encoding():
    sc = _scene()
    eng = I3DRSGM()
    res = eng.forward_match(sc.left, sc.right)
    enc = np.asarray(eng.reference_encoded(res))
    v = np.asarray(res.valid)
    assert (enc[~v] == -10000.0).all()
    np.testing.assert_allclose(enc[v], np.asarray(res.disparity)[v] * -16.0)


def test_backward_match_runs():
    sc = _scene()
    eng = I3DRSGM()
    res = eng.backward_match(sc.left, sc.right)
    assert res.disparity.shape == sc.left.shape


def test_subpix_profile_runs():
    sc = _scene()
    cfg = ALGORITHM_DEFAULTS[Algorithm.I3DRSGM]
    res = pyramid_sgm_match(sc.left, sc.right, cfg, subpix_profile())
    d = np.asarray(res.disparity)
    v = np.asarray(res.valid) & sc.valid
    assert np.median(np.abs(d - sc.disparity)[v]) < 0.5


# ------------------------------------------------------------- ops ----------

def test_halfpel_refine_improves_fractional_shift():
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, (48, 80)).astype(np.float32)
    base = 0.5 * (base + np.roll(base, 1, 1))  # band-limit
    # right = left shifted by 6.5 px (linear interp)
    xs = np.arange(80)
    right = np.stack([np.interp(xs + 6.5, xs, row) for row in base]).astype(np.float32)
    disp0 = np.full((1, 48, 80), 6.0, np.float32)  # integer estimate
    refined = halfpel_refine(jnp.asarray(base)[None], jnp.asarray(right)[None],
                             jnp.asarray(disp0), jnp.ones((1, 48, 80), bool))
    inner = np.asarray(refined)[0, 4:-4, 10:-10]
    assert abs(np.median(inner) - 6.5) < 0.2


def test_occlusion_detection_on_step_scene():
    # foreground bar occludes background to its left in the right view
    H, W = 32, 64
    disp = np.full((1, H, W), 5.0, np.float32)
    disp[:, :, 30:40] = 15.0  # foreground
    valid = np.ones((1, H, W), bool)
    occ = np.asarray(detect_occlusions(jnp.asarray(disp), jnp.asarray(valid)))
    # background pixels whose warped column collides with the bar:
    # x - 5 in [30-15, 40-15) -> x in [20, 30)
    assert occ[0, 5, 22] and occ[0, 5, 28]
    assert not occ[0, 5, 10]
    assert not occ[0, 5, 35]  # foreground never occluded

    filled, newvalid = fill_occlusions(jnp.asarray(disp), jnp.asarray(valid),
                                       jnp.asarray(occ))
    f = np.asarray(filled)
    assert abs(f[0, 5, 25] - 5.0) < 1e-5  # background fill
    assert np.asarray(newvalid)[0, 5, 25]


# ------------------------------------------------------ backmatching --------

def test_true_backmatch_kills_occlusions():
    """The backmatching check must invalidate most GT-occluded pixels
    while keeping most visible ones."""
    sc = layered_scene(96, 160, max_disp=24, seed=7)
    cfg = ALGORITHM_DEFAULTS[Algorithm.I3DRSGM].replace(
        disparity_range=32, speckle_size=0, backmatch_distance=1.5)
    res = pyramid_sgm_match(sc.left, sc.right, cfg)
    v = np.asarray(res.valid)
    occluded = ~sc.valid
    if occluded.sum() > 50:
        # most occluded pixels rejected, most visible pixels kept
        assert v[occluded].mean() < 0.45
    assert v[sc.valid].mean() > 0.75


def test_uniqueness_ratio_applies_on_pyramid_path():
    """cfg.uniqueness_ratio must actually gate the flagship WTA; the
    engine default is 0 (quick.param has no uniqueness key)."""
    assert ALGORITHM_DEFAULTS[Algorithm.I3DRSGM].uniqueness_ratio == 0.0
    sc = layered_scene(96, 128, max_disp=20, seed=9)
    base = ALGORITHM_DEFAULTS[Algorithm.I3DRSGM].replace(
        disparity_range=32, speckle_size=0, backmatch_distance=-1.0)
    d0 = pyramid_sgm_match(sc.left, sc.right, base)
    d40 = pyramid_sgm_match(sc.left, sc.right,
                            base.replace(uniqueness_ratio=40.0))
    v0 = np.asarray(d0.valid).mean()
    v40 = np.asarray(d40.valid).mean()
    assert v40 < v0  # a 40% margin filter must reject something
    assert v40 > 0.2  # but not everything


def test_gauss_interpolator_fills_directionally():
    """quick.param's "Interpolator Mode = Gauss, Number Of Directions =
    32": holes fill from nearest valid values along rays, weighted by
    Gaussian distance — near a depth edge the near side dominates."""
    from i3dr_stereo_tpu.ops.gauss_interp import gauss_interpolate

    H, W = 64, 96
    d = np.full((H, W), 10.0, np.float32)
    d[:, 48:] = 30.0                     # depth edge at x=48
    v = np.ones((H, W), bool)
    v[20:28, 40:46] = False              # hole fully on the 10-side
    v[30:38, 60:80] = False              # wide hole on the 30-side
    out, nv = gauss_interpolate(jnp.asarray(d), jnp.asarray(v))
    out = np.asarray(out)
    assert np.asarray(nv).all()
    # hole on the 10 side fills near 10 (its center is 4 px from valid
    # 10-values and >= 8 px from any 30-value)
    assert abs(out[24, 43] - 10.0) < 2.0
    # wide hole on the 30 side fills near 30
    assert abs(out[34, 70] - 30.0) < 2.0
    # valid pixels untouched
    np.testing.assert_array_equal(out[v], d[v])


def test_quick_profile_uses_gauss_interpolator():
    from i3dr_stereo_tpu.config.profile import quick_profile

    p = quick_profile()
    lv = p.enabled_levels[0]
    assert lv.interpolator_mode == "gauss"
    assert lv.interp_directions == 32
