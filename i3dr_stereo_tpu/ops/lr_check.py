"""Left-right consistency ("backmatching") without a second match.

The reference gets this either from cv::ximgproc::createRightMatcher (a
full backward match, matcherOpenCVBlock.cpp:46-51) or from the engine's
"Compute Backmatching" + "Maximum Backmatching Distance = 1.5"
(ini/quick.param:122). Here the right-image cost volume is a pure
re-indexing of the already-aggregated left volume —
``S_R(y, x_r, d) = S_L(y, x_r + d, d)`` — one gather, no second SGM.
This matches cv::StereoSGBM's internal disp2 computation.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

BIG = 1.0e9


@partial(jax.jit, static_argnames=("min_disparity",))
def right_cost_volume(S: jax.Array, min_disparity: int = 0) -> jax.Array:
    """(B, H, W, D) left-aggregated costs -> right-anchored costs."""
    batched = S.ndim == 4
    Sb = S if batched else S[None]
    B, H, W, D = Sb.shape
    xr = jnp.arange(W)[:, None]
    d = jnp.arange(D)[None, :] + min_disparity
    src = xr + d                              # left x that maps to right x under d
    valid = (src >= 0) & (src < W)
    src_c = jnp.clip(src, 0, W - 1)
    out = jnp.take_along_axis(Sb, src_c[None, None, :, :], axis=2)
    out = jnp.where(valid[None, None], out, BIG)
    return out if batched else out[0]


@partial(jax.jit, static_argnames=("min_disparity",))
def lr_consistency(disp: jax.Array, valid: jax.Array, S: jax.Array,
                   min_disparity: int = 0, max_diff: float = 1.0,
                   ) -> tuple[jax.Array, jax.Array]:
    """Invalidate pixels failing |d_R(x - d_L(x)) - d_L(x)| <= max_diff.

    disp: (B, H, W) absolute-pixel disparities; S the aggregated left
    volume used to derive the right disparity by WTA on the re-indexed
    volume. Comparison uses integer (rounded) disparities like cv SGBM's
    disp2 check.
    """
    batched = disp.ndim == 3
    dispb = disp if batched else disp[None]
    validb = valid if batched else valid[None]
    Sb = S if batched else S[None]
    B, H, W = dispb.shape

    SR = right_cost_volume(Sb, min_disparity)
    rbest = jnp.argmin(SR, axis=-1) + min_disparity        # (B, H, W) int
    rvalid = jnp.min(SR, axis=-1) < BIG / 2

    d_int = jnp.round(dispb).astype(jnp.int32)
    xr = jnp.arange(W)[None, None, :] - d_int              # right-image x
    in_img = (xr >= 0) & (xr < W)
    xr_c = jnp.clip(xr, 0, W - 1)
    r_at = jnp.take_along_axis(rbest, xr_c, axis=2)
    r_ok = jnp.take_along_axis(rvalid, xr_c, axis=2)
    consistent = jnp.abs(r_at - d_int) <= max_diff
    ok = validb & in_img & r_ok & consistent
    if not batched:
        ok = ok[0]
    return disp, ok
