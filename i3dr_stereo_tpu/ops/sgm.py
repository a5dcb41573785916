"""Semi-global matching path aggregation.

The core recurrence the reference buys from closed libraries
(cv::StereoSGBM internals; the licensed Phobos engine's 4-direction
optimization, ini/quick.param:144-147):

    L_r(p, d) = C(p, d) + min( L_r(p-r, d),
                               L_r(p-r, d-1) + P1,
                               L_r(p-r, d+1) + P1,
                               min_k L_r(p-r, k) + P2 ) - min_k L_r(p-r, k)

This module is the **plain XLA reference**: every direction is a
`lax.scan` along rows or columns with the whole perpendicular extent x
disparity vectorized per step (shape (B, H, D) or (B, W, D)). Diagonal
paths reuse the row scan with the carry shifted one column per step, so
no wavefront scheduling is needed. The GPU kernel in
:mod:`i3dr_stereo_tpu.ops.sgm_triton` implements the same contract; tests
and ``chip_smoke.py`` assert bit-equality between the two.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

BIG = 1.0e9

# (dy, dx) path directions, named from where the path COMES FROM.
DIRECTIONS_8: Tuple[Tuple[int, int], ...] = (
    (0, 1), (0, -1),          # W->E, E->W  (horizontal)
    (1, 0), (-1, 0),          # N->S, S->N  (vertical)
    (1, 1), (-1, -1),         # NW->SE, SE->NW
    (1, -1), (-1, 1),         # NE->SW, SW->NE
)
# The reference Phobos profile runs 4 two-way optimizations as 4 one-way
# passes each way? No — "SGM South-North Optimization" etc. are bi-directional
# optimizations in the engine; the classic 4-path set used on GPUs:
DIRECTIONS_4: Tuple[Tuple[int, int], ...] = ((0, 1), (0, -1), (1, 0), (-1, 0))
# cv::StereoSGBM MODE_SGBM single-pass set (5 directions).
DIRECTIONS_5: Tuple[Tuple[int, int], ...] = ((0, 1), (1, 0), (1, 1), (1, -1), (0, -1))


def _shift_d(x: jax.Array, k: int) -> jax.Array:
    """Shift along the disparity (last) axis, filling with BIG."""
    fill = jnp.full(x.shape[:-1] + (abs(k),), BIG, dtype=x.dtype)
    if k > 0:
        return jnp.concatenate([fill, x[..., :-k]], axis=-1)
    return jnp.concatenate([x[..., -k:], fill], axis=-1)


def _shift_spatial(x: jax.Array, k: int, axis: int) -> jax.Array:
    """Shift along a spatial axis, filling with 0 where the path enters
    the image — a zero carry makes the step reduce to L = C exactly
    (min(0, 0+p1, 0+p2) - 0 == 0), with no huge-value f32 rounding."""
    if k == 0:
        return x
    pad = [(0, 0)] * x.ndim
    idx = [slice(None)] * x.ndim
    if k > 0:
        pad[axis] = (k, 0)
        idx[axis] = slice(0, x.shape[axis])
    else:
        pad[axis] = (0, -k)
        idx[axis] = slice(-k, x.shape[axis] - k)
    return jnp.pad(x, pad, constant_values=0.0)[tuple(idx)]


def _sgm_step(prev: jax.Array, c: jax.Array, p1: float, p2: float) -> jax.Array:
    """One scanline step of the SGM recurrence (vectorized over B x N x D)."""
    m = jnp.min(prev, axis=-1, keepdims=True)
    best = jnp.minimum(
        jnp.minimum(prev, m + p2),
        jnp.minimum(_shift_d(prev, 1) + p1, _shift_d(prev, -1) + p1),
    )
    return c + best - m


def _aggregate_one_direction(C: jax.Array, dy: int, dx: int,
                             p1: float, p2: float) -> jax.Array:
    """L_r for one direction. C: (B, H, W, D) float32."""
    B, H, W, D = C.shape

    if dy == 0:
        # scan over columns; carry (B, H, D)
        xs = jnp.moveaxis(C, 2, 0)  # (W, B, H, D)
        if dx < 0:
            xs = xs[::-1]

        def step(prev, c):
            L = _sgm_step(prev, c, p1, p2)
            return L, L

        # derive from data (not a constant) so shard_map's varying-axes
        # check accepts the carry
        init = xs[0] * 0.0
        _, Ls = jax.lax.scan(step, init, xs)
        if dx < 0:
            Ls = Ls[::-1]
        return jnp.moveaxis(Ls, 0, 2)

    # scan over rows; carry (B, W, D); diagonal directions shift the carry
    # one column per row so the predecessor is (y-dy, x-dx).
    xs = jnp.moveaxis(C, 1, 0)  # (H, B, W, D)
    if dy < 0:
        xs = xs[::-1]

    def step(prev, c):
        prev_sh = _shift_spatial(prev, dx, axis=1) if dx != 0 else prev
        L = _sgm_step(prev_sh, c, p1, p2)
        return L, L

    init = xs[0] * 0.0
    _, Ls = jax.lax.scan(step, init, xs)
    if dy < 0:
        Ls = Ls[::-1]
    return jnp.moveaxis(Ls, 0, 1)


@partial(jax.jit, static_argnames=("directions",))
def sgm_aggregate(C: jax.Array, p1=10.0, p2=120.0,
                  directions: Sequence[Tuple[int, int]] = DIRECTIONS_8,
                  per_direction_penalties=None,
                  ) -> jax.Array:
    """Sum of L_r over the requested path directions.

    ``per_direction_penalties`` optionally gives (P1, P2) per direction in
    the same order — the Phobos profile exposes per-direction penalties
    (quick.param "SN/SE-NW/SW-NE/WE Penalty 1/2"; I3DRSGM.cpp:307-358).
    Penalties may be python floats or traced scalars (live reconfigure
    without re-tracing).
    """
    batched = C.ndim == 4
    Cb = C if batched else C[None]
    S = jnp.zeros_like(Cb)
    for i, (dy, dx) in enumerate(directions):
        pp1, pp2 = (p1, p2) if per_direction_penalties is None else per_direction_penalties[i]
        S = S + _aggregate_one_direction(Cb, dy, dx, pp1, pp2)
    return S if batched else S[0]
