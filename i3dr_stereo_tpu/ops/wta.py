"""Winner-take-all disparity extraction: argmin + uniqueness + subpixel.

Replicates cv::StereoSGBM / cv::StereoBM selection semantics so the
matcher backends can hit the reference's accuracy baseline:

- best d = argmin_d S(p, d)
- uniqueness: invalid if any d with |d - best| > 1 has
  S[d] * (100 - uniquenessRatio) < S[best] * 100  (cv SGBM loop)
- parabolic subpixel: d + (S[d-1] - S[d+1]) / (2 (S[d-1] + S[d+1] - 2 S[d])),
  only for interior d (the "DSI Interpolator = Parabolic" of quick.param:81)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

BIG = 1.0e9


@partial(jax.jit, static_argnames=("min_disparity", "subpixel"))
def wta_disparity(S: jax.Array, min_disparity: int = 0, *,
                  uniqueness_ratio: float = 0.0,
                  subpixel: bool = True) -> tuple[jax.Array, jax.Array]:
    """S: (..., D) aggregated costs -> (disparity float32 px, valid bool).

    Disparity is returned in *absolute* pixels (min_disparity offset
    applied). Entries whose best cost is BIG-level (no valid candidate)
    are invalid.
    """
    D = S.shape[-1]
    if not jnp.issubdtype(S.dtype, jnp.floating):
        # integer aggregates (uint8-cost path): saturated-invalid entries
        # sit at >= CLAMP per pass; callers also carry a cost-level valid
        S = S.astype(jnp.float32)
        invalid_level = 9999.0
    else:
        invalid_level = BIG / 2
    best = jnp.argmin(S, axis=-1)
    Sbest = jnp.min(S, axis=-1)
    valid = Sbest < invalid_level

    ur_static = isinstance(uniqueness_ratio, (int, float))
    if not ur_static or uniqueness_ratio > 0:
        # uniqueness may be a traced scalar (live reconfigure): evaluate
        # unconditionally then, with <= 0 reducing to a no-op
        d_idx = jnp.arange(D)
        far = jnp.abs(d_idx - best[..., None]) > 1
        S_far = jnp.where(far, S, jnp.inf)
        min_far = jnp.min(S_far, axis=-1)
        ok = min_far * (100.0 - uniqueness_ratio) >= Sbest * 100.0
        if not ur_static:
            ok = ok | (jnp.asarray(uniqueness_ratio) <= 0)
        valid = valid & ok

    disp = best.astype(jnp.float32)
    if subpixel:
        # pick S[best -+ 1] with one-hot masked reductions over the
        # (rolled) volume, which XLA fuses into the WTA pass
        d_idx = jnp.arange(D)
        onehot = d_idx == best[..., None]
        Sm_roll = jnp.concatenate([S[..., :1], S[..., :-1]], axis=-1)  # S[d-1]
        Sp_roll = jnp.concatenate([S[..., 1:], S[..., -1:]], axis=-1)  # S[d+1]
        Sm = jnp.sum(jnp.where(onehot, Sm_roll, 0.0), axis=-1)
        Sp = jnp.sum(jnp.where(onehot, Sp_roll, 0.0), axis=-1)
        denom = Sm + Sp - 2.0 * Sbest
        offset = jnp.where(denom > 1e-9,
                           (Sm - Sp) / (2.0 * denom),
                           0.0)
        offset = jnp.clip(offset, -0.5, 0.5)
        interior = (best > 0) & (best < D - 1)
        disp = disp + jnp.where(interior, offset, 0.0)

    disp = disp + float(min_disparity)
    return disp, valid
