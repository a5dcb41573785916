"""Accuracy gate at the reference's 1280x1024 operating point
(BASELINE config 2: SGBM, 128 disparities, subpixel — the scale of
launch/stereo_matcher.launch:37-38) run in CI on CPU. The 2448x2048
pyramid case runs on a GPU via accuracy_bench.py and chip_smoke.py;
this keeps the mid-scale gate continuously enforced (~2 min)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_sgbm_1280x1024_128d_subpix_gate():
    from accuracy_bench import sgbm_1280

    row = sgbm_1280()
    assert row["density"] > 0.7, row
    assert row["median_px_vs_cv_sgbm"] < 0.25, row
    assert row["median_px"] < 0.25, row
    assert row["bad1_pct"] < 5.0, row


def test_i3drsgm_hard_fractional_asym_gate():
    """Reduced-size version of the HARD full-res accuracy row (verdict
    r3 #1): quarter-pixel disparities + photometric asymmetry. The gate
    is the same <0.25 px median plus a bad-pixel bound — a matcher that
    merely locks onto integer shifts fails the median here."""
    from accuracy_bench import i3drsgm_hard_2448

    row = i3drsgm_hard_2448(H=512, W=1024)
    assert row["density"] > 0.6, row
    assert row["median_px"] < 0.25, row
    assert row["bad1_pct"] < 6.0, row
    # the oracle on the same pair must be honestly nonzero now
    assert row["cv_sgbm_median_px_vs_gt"] > 0.0, row


def test_i3drsgm_slanted_subpixel_gate():
    from accuracy_bench import slanted_2448

    row = slanted_2448(H=512, W=1024)
    assert row["density"] > 0.6, row
    assert row["median_px"] < 0.25, row
    assert row["bad1_pct"] < 6.0, row
