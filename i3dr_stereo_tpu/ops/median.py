"""3x3 median filter (the engine's "Disparity Median Optimizer",
ini/quick.param:89-90, kernel 3x3) and cv::StereoSGBM's final medianBlur.

Median-of-9 as a min/max exchange network (19 compare-exchanges, Paeth's
network) over nine shifted views of the image. Every op is elementwise,
so XLA fuses the whole filter into a single pass over the image — no
(H, W, 9) stack, no sort, no minor-axis relayout.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _shifts9(x: jax.Array, pad_mode: str = "edge", **pad_kw) -> list[jax.Array]:
    """(…, H, W) -> nine shifted copies (the 3x3 neighbourhood views)."""
    pad = [(0, 0)] * (x.ndim - 2) + [(1, 1), (1, 1)]
    p = jnp.pad(x, pad, mode=pad_mode, **pad_kw)
    H, W = x.shape[-2], x.shape[-1]
    return [p[..., dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)]


def _median9(v: list[jax.Array]) -> jax.Array:
    """Median of nine same-shape arrays via Paeth's 19-exchange network."""
    v = list(v)

    def op(i, j):
        a, b = v[i], v[j]
        v[i] = jnp.minimum(a, b)
        v[j] = jnp.maximum(a, b)

    op(1, 2); op(4, 5); op(7, 8)
    op(0, 1); op(3, 4); op(6, 7)
    op(1, 2); op(4, 5); op(7, 8)
    op(0, 3); op(5, 8); op(4, 7)
    op(3, 6); op(1, 4); op(2, 5)
    op(4, 7); op(4, 2); op(6, 4)
    op(4, 2)
    return v[4]


@jax.jit
def median3x3(x: jax.Array) -> jax.Array:
    """(…, H, W) -> same shape, 3x3 median with edge-replicated borders."""
    return _median9(_shifts9(x))


@jax.jit
def median3x3_masked(x: jax.Array, valid: jax.Array) -> jax.Array:
    """Median that ignores invalid samples ("Nodata Policy = Ignore",
    ini/quick.param): invalid neighbours are replaced by the centre value
    before the median, so they never influence it.

    Invalidity rides a NaN sentinel in the shifted value planes (one set
    of 9 shifts instead of shifting values AND a bool mask — halves the
    pass's traffic at 2048x2448)."""
    c = jnp.where(valid, x.astype(jnp.float32), jnp.nan)
    nbs = _shifts9(c, pad_mode="constant", constant_values=jnp.nan)
    vals = [jnp.where(jnp.isnan(nb), x, nb) for nb in nbs]
    return _median9(vals)
