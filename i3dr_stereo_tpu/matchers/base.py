"""Matcher facade: the JAX equivalent of AbstractStereoMatcher.

The reference contract (include/stereoMatcher/abstractStereoMatcher.h:12-92):
``setImages`` (with optional cubic downsample), parameter setters,
``match()`` = forwardMatch + CV_32F convert, ``getDisparity`` with the
x16 fixed-point convention applied by the caller
(generate_disparity.cpp:402-436).

Here the core is a pure function ``(left, right, config) -> MatchResult``
selected from the registry and jitted per config shape-key; the
``StereoMatcher`` class is a thin host-side wrapper that caches compiled
executables and implements the reference's conventions (downsample,
fixed-point, nodata encodings) so a user of the reference finds the same
surface.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from i3dr_stereo_tpu.config.params import Algorithm, MatcherConfig
from i3dr_stereo_tpu.core.frame import to_mono_f32

NODATA = -10000.0   # I3DRSGM nodata convention (I3DRSGM.cpp:142-145)
MISSING_Z = 10000.0  # generate_disparity.cpp MISSING_Z


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MatchResult:
    """Disparity in absolute pixels + validity, plus optional extras."""

    disparity: jax.Array       # (..., H, W) float32, absolute pixels
    valid: jax.Array           # (..., H, W) bool

    # --- reference-compatible encodings -------------------------------------
    def fixed_point(self, scale: int = 16, min_disparity: int = 0) -> jax.Array:
        """x16 int16 encoding (DPP=16, generate_disparity.cpp:402-436);
        invalid pixels get (minDisparity-1)*16 like cv::StereoBM/SGBM."""
        d = jnp.where(self.valid, self.disparity, float(min_disparity) - 1.0)
        return jnp.round(d * scale).astype(jnp.int16)

    def with_missing_z(self) -> jax.Array:
        """float32 disparity with invalid = MISSING_Z (10000), the
        encoding generate_disparity publishes (cpp:449-452)."""
        return jnp.where(self.valid, self.disparity, MISSING_Z)

    def with_nodata(self) -> jax.Array:
        """float32 disparity with invalid = -10000 (I3DRSGM convention)."""
        return jnp.where(self.valid, self.disparity, NODATA)


MatcherFn = Callable[[jax.Array, jax.Array, MatcherConfig], MatchResult]


def _downsample(img: jax.Array, scale: float) -> jax.Array:
    """Cubic resize, mirroring AbstractStereoMatcher::setImages
    (abstractStereoMatcher.cpp:9-30, INTER_CUBIC resize by downsample_scale)."""
    if scale == 1.0:
        return img
    H, W = img.shape[-2:]
    new = img.shape[:-2] + (int(round(H * scale)), int(round(W * scale)))
    return jax.image.resize(img, new, method="cubic")


def _upsample_disparity(res: MatchResult, out_hw: Tuple[int, int], scale: float) -> MatchResult:
    """Invert the downsample: resize disparity back and rescale values by
    1/scale (a disparity measured on a half-size image doubles)."""
    if scale == 1.0:
        return res
    d = jax.image.resize(res.disparity, res.disparity.shape[:-2] + out_hw, method="nearest")
    v = jax.image.resize(res.valid.astype(jnp.float32),
                         res.valid.shape[:-2] + out_hw, method="nearest") > 0.5
    return MatchResult(disparity=d / scale, valid=v)


class StereoMatcher:
    """Stateful wrapper: config + per-shape compiled executables.

    Unlike the reference, parameter changes never rebuild an engine
    (cf. I3DRSGM.cpp:630-654's destroy/recreate per setter): non-shape
    parameters re-bake a closure constant (one retrace at next call),
    shape parameters change the cache key.
    """

    def __init__(self, config: MatcherConfig):
        self._config = config.sanitize()
        self._cache: Dict[tuple, Callable] = {}

    @property
    def config(self) -> MatcherConfig:
        return self._config

    def set_config(self, config: MatcherConfig) -> None:
        self._config = config.sanitize()

    def update(self, **kw) -> None:
        """Live reconfigure (the dynamic_reconfigure path)."""
        self._config = self._config.replace(**kw)

    # -- the match path -------------------------------------------------------
    def _compiled(self, shape: tuple, dtype) -> Callable:
        key = (shape, str(dtype), self._config.shape_key(),
               dataclasses.astuple(self._config))
        fn = self._cache.get(key)
        if fn is None:
            from i3dr_stereo_tpu.matchers.registry import MATCHER_REGISTRY
            cfg = self._config
            impl = MATCHER_REGISTRY[cfg.algorithm]

            def run(l, r):
                li = _downsample(to_mono_f32(l), cfg.downsample_scale)
                ri = _downsample(to_mono_f32(r), cfg.downsample_scale)
                res = impl(li, ri, cfg)
                return _upsample_disparity(res, l.shape[-2:], cfg.downsample_scale)

            fn = jax.jit(run)
            self._cache[key] = fn
        return fn

    def match(self, left, right) -> MatchResult:
        left = jnp.asarray(left)
        right = jnp.asarray(right)
        return self._compiled(left.shape, left.dtype)(left, right)

    # reference-compatible aliases (abstractStereoMatcher.h)
    forward_match = match

    def backward_match(self, left, right) -> MatchResult:
        """Right-anchored disparity: match with swapped, mirrored images.

        d_R(x_r) = d_L at the mirrored location — the standard
        createRightMatcher trick (matcherOpenCVBlock.cpp:46-51)."""
        l = jnp.asarray(left)[..., ::-1]
        r = jnp.asarray(right)[..., ::-1]
        res = self._compiled(l.shape, l.dtype)(r, l)
        return MatchResult(disparity=res.disparity[..., ::-1],
                           valid=res.valid[..., ::-1])


def create_matcher(config: MatcherConfig | Algorithm) -> StereoMatcher:
    """Factory keyed by the reference's algorithm enum
    (init_matcher, generate_disparity.cpp:263-331)."""
    if isinstance(config, Algorithm):
        from i3dr_stereo_tpu.config.params import ALGORITHM_DEFAULTS
        config = ALGORITHM_DEFAULTS[config]
    return StereoMatcher(config)
