"""Directional Gauss gap interpolator — the engine's "Interpolator Mode
= Gauss" with "Interpolator Number Of Directions = 32"
(ini/quick.param:111-117): each invalid pixel is filled
from the nearest valid disparity along N rays, combined with Gaussian
distance weights. Unlike isotropic diffusion (ops/wls.py), the
directional form stays sharp near large holes: a hole next to a depth
edge takes most of its weight from the near side of the edge.

Data-parallel formulation: per ray, the (value, distance) of the nearest
valid pixel along the ray is found by DISTANCE DOUBLING — log2(R) jump
rounds of `jnp.roll` by the rounded direction offset (pointer-jumping on
the pixel lattice, no gathers, no scans over H or W). All N rays are
vector ops over the full image; XLA fuses each round into a couple of
passes. Cost: N * log2(R) * O(HW).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

BIG = 1.0e9


def _shift_with_fill(x: jax.Array, dy: int, dx: int, fill) -> jax.Array:
    """x shifted so out[p] = x[p + (dy, dx)], out-of-image -> fill."""
    H, W = x.shape[-2], x.shape[-1]
    out = jnp.roll(x, (-dy, -dx), axis=(-2, -1))
    ri = jnp.arange(H)[:, None]
    ci = jnp.arange(W)[None, :]
    ok = ((ri + dy >= 0) & (ri + dy < H) & (ci + dx >= 0) & (ci + dx < W))
    return jnp.where(ok, out, fill)


@partial(jax.jit, static_argnames=("n_directions", "max_radius", "sigma",
                                   "min_elements"))
def gauss_interpolate(disp: jax.Array, valid: jax.Array, *,
                      n_directions: int = 32, max_radius: int = 64,
                      sigma: float = 16.0, min_elements: int = 0
                      ) -> tuple[jax.Array, jax.Array]:
    """Fill invalid pixels from N-ray nearest-valid Gaussian blending.

    disp: (B, H, W) or (H, W); valid: same-shape bool. Returns
    (filled, new_valid) — valid pixels pass through untouched; a hole
    becomes valid when >= max(min_elements, 1) rays found support within
    ``max_radius`` px ("Interpolator Minimum Number Of Elements",
    quick.param:114).
    """
    batched = disp.ndim == 3
    d = (disp if batched else disp[None]).astype(jnp.float32)
    v = valid if batched else valid[None]

    wsum = jnp.zeros_like(d)
    vsum = jnp.zeros_like(d)
    nrays = jnp.zeros_like(d)
    rounds = max(1, math.ceil(math.log2(max(max_radius, 2))))

    for k in range(n_directions):
        ang = 2.0 * math.pi * k / n_directions
        uy, ux = math.sin(ang), math.cos(ang)
        val = jnp.where(v, d, 0.0)
        dst = jnp.where(v, 0.0, BIG)
        step = 1.0
        for _ in range(rounds):
            dy, dx = int(round(uy * step)), int(round(ux * step))
            if dy or dx:
                sl = math.hypot(dy, dx)
                v2 = _shift_with_fill(val, dy, dx, 0.0)
                d2 = _shift_with_fill(dst, dy, dx, BIG) + sl
                take = d2 < dst
                val = jnp.where(take, v2, val)
                dst = jnp.where(take, d2, dst)
            step *= 2.0
        hit = dst < min(max_radius, BIG / 2)
        w = jnp.where(hit, jnp.exp(-(dst * dst) / (2.0 * sigma * sigma)), 0.0)
        wsum = wsum + w
        vsum = vsum + w * val
        nrays = nrays + hit.astype(jnp.float32)

    filled = jnp.where(wsum > 0, vsum / jnp.maximum(wsum, 1e-20), 0.0)
    # wsum can underflow to 0 when every hit sits many sigma away —
    # a "filled" value of 0.0 must not be marked valid
    ok_fill = (nrays >= max(min_elements, 1)) & (wsum > 0)
    out = jnp.where(v, d, filled)
    new_valid = v | ok_fill
    if not batched:
        out, new_valid = out[0], new_valid[0]
    return out, new_valid
