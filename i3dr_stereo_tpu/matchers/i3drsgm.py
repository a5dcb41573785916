"""I3DRSGM engine facade: the licensed-engine wrapper surface, JAX-backed.

Re-creates the public surface of the reference's ``I3DRSGM`` class
(include/stereoMatcher/I3DRSGM.h:18-86) and its adapter
(matcherI3DRSGM.{h,cpp}) on top of the pyramid SGM:

- construction from a ``.param`` INI file (same dialect as
  ini/quick.param — parsed once into a typed SGMProfile instead of the
  reference's find-and-replace on 737 text lines, I3DRSGM.cpp:40-140),
- every setter of the wrapper, including its ROS-unit quirks (P1/P2
  /1000, disparity range /10 forced odd, speckle /10, min_disparity ->
  top prediction shift /20 — I3DRSGM.cpp:249-508),
- pyramid enable/max level (I3DRSGM.cpp:405-469),
- forward/backward match; backward via mirrored inputs like
  createRightMatcher,
- nodata -10000 output convention and the adapter's x(-16) fixed-point
  flip (matcherI3DRSGM.cpp:36,43).

Setters mutate the typed profile and at worst trigger ONE re-jit at the
next match — never a destroy/recreate of an engine handle
(cf. I3DRSGM.cpp:630-654 doing that once per parameter).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from i3dr_stereo_tpu.config.params import ALGORITHM_DEFAULTS, Algorithm, MatcherConfig
from i3dr_stereo_tpu.config.profile import (
    NODATA_VALUE,
    SGMProfile,
    quick_profile,
)
from i3dr_stereo_tpu.matchers.base import MatchResult
from i3dr_stereo_tpu.matchers.pyramid import pyramid_sgm_match


def _replace_levels(profile: SGMProfile, **kw) -> SGMProfile:
    return dataclasses.replace(
        profile,
        levels=tuple(dataclasses.replace(lv, **kw) for lv in profile.levels))


class I3DRSGM:
    """Drop-in engine object with the reference wrapper's method names."""

    def __init__(self, param_file: Optional[str] = None,
                 profile: Optional[SGMProfile] = None):
        if profile is not None:
            self.profile = profile
        elif param_file is not None:
            self.profile = SGMProfile.from_param_file(param_file)
        else:
            self.profile = quick_profile()
        self.config = ALGORITHM_DEFAULTS[Algorithm.I3DRSGM]
        self.nodata = NODATA_VALUE
        self._cache = {}

    # -- match ----------------------------------------------------------------
    def _fn(self, shape, dtype):
        key = (shape, str(dtype), self.profile, dataclasses.astuple(self.config))
        fn = self._cache.get(key)
        if fn is None:
            prof, cfg = self.profile, self.config
            fn = jax.jit(lambda l, r: pyramid_sgm_match(l, r, cfg, prof))
            self._cache[key] = fn
        return fn

    def forward_match(self, left, right) -> MatchResult:
        left = jnp.asarray(left, dtype=jnp.float32)
        right = jnp.asarray(right, dtype=jnp.float32)
        return self._fn(left.shape, left.dtype)(left, right)

    def backward_match(self, left, right) -> MatchResult:
        l = jnp.asarray(left, dtype=jnp.float32)[..., ::-1]
        r = jnp.asarray(right, dtype=jnp.float32)[..., ::-1]
        res = self._fn(l.shape, l.dtype)(r, l)
        return MatchResult(disparity=res.disparity[..., ::-1],
                           valid=res.valid[..., ::-1])

    match = forward_match

    def reference_encoded(self, res: MatchResult) -> jax.Array:
        """The adapter's output convention: disparity x(-16), invalid ->
        nodata (matcherI3DRSGM.cpp:36-47; I3DRSGM.cpp:142-145)."""
        return jnp.where(res.valid, res.disparity * -16.0, self.nodata)

    # -- reference setter surface (ROS unit conventions) ----------------------
    def setP1(self, ros_value: float) -> None:
        v = ros_value / 1000.0
        self.profile = _replace_levels(self.profile, p1=(v, v, v, v))

    def setP2(self, ros_value: float) -> None:
        v = ros_value / 1000.0
        self.profile = _replace_levels(self.profile, p2=(v, v, v, v))

    def setDisparityRange(self, ros_value: int) -> None:
        n = int(ros_value / 10)
        if n % 2 == 0:
            n += 1
        self.profile = _replace_levels(self.profile, num_disparities=n)

    def setSpeckleDifference(self, ros_value: float) -> None:
        self.profile = _replace_levels(self.profile,
                                       speckle_max_diff=ros_value / 10.0)

    def setSpeckleSize(self, ros_value: int) -> None:
        self.profile = _replace_levels(self.profile,
                                       speckle_max_region=int(ros_value / 10))

    def setMinDisparity(self, ros_value: float) -> None:
        shift = ros_value / 20.0
        levels = list(self.profile.levels)
        coarse = max(lv.level for lv in levels)
        self.profile = dataclasses.replace(
            self.profile,
            levels=tuple(dataclasses.replace(
                lv, prediction_shift=shift if lv.level == coarse else 0.0)
                for lv in levels))

    def setWindowSize(self, size: int) -> None:
        size = min(int(size), 17)
        if size % 2 == 0:
            size += 1
        self.profile = _replace_levels(self.profile, census_w=size, census_h=size)

    def setBackmatchingDistance(self, d: float) -> None:
        self.profile = _replace_levels(self.profile, backmatch_dist=d)

    def enableBackmatching(self, on: bool) -> None:
        self.profile = _replace_levels(self.profile, backmatch=bool(on))

    def enableSubpixel(self, on: bool) -> None:
        self.profile = _replace_levels(self.profile, subpixel=bool(on))

    def enableInterpolation(self, on: bool) -> None:
        self.profile = _replace_levels(self.profile, interpolate_gaps=bool(on))

    def enableOcclusionDetection(self, on: bool) -> None:
        self.profile = _replace_levels(self.profile, occlusion_detection=bool(on))

    def enableOcclusionInterpolation(self, on: bool) -> None:
        self.profile = _replace_levels(self.profile,
                                       interpolate_occlusions=bool(on))

    def enablePyramid(self, min_level: int, max_level: int) -> None:
        self.profile = self.profile.with_levels_enabled(min_level, max_level)

    def maxPyramid(self, level: int) -> None:
        """I3DRSGM.cpp:442-469: enable pyramids 0..level."""
        self.profile = self.profile.with_levels_enabled(0, level)

    def enableCPU(self, on: bool) -> None:
        """Reference: switch engine to CPU (I3DRSGM.cpp:214-235); here:
        force the plain XLA aggregation instead of the GPU kernel."""
        import os

        os.environ["I3DR_SGM_BACKEND"] = "xla" if on else "auto"

    def setNoDataValue(self, v: float) -> None:
        self.nodata = float(v)
