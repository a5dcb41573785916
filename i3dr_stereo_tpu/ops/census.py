"""Census transform + hamming cost volume.

The matching cost of the reference's flagship I3DRSGM engine
(``Feature Set = census``, ``Feature Set Size X/Y = 9`` —
ini/quick.param:99,105-106). A 9x9 census window is 80 neighbour
comparisons, packed here into 3 uint32 bit-planes; the hamming distance
is XOR + ``lax.population_count``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from i3dr_stereo_tpu.ops.shift import gather_disparity_shifted

BIG_COST = 1.0e9


def _window_offsets(h: int, w: int):
    assert h % 2 == 1 and w % 2 == 1, "census window must be odd"
    offs = [(dy, dx)
            for dy in range(-(h // 2), h // 2 + 1)
            for dx in range(-(w // 2), w // 2 + 1)
            if not (dy == 0 and dx == 0)]
    return offs


@partial(jax.jit, static_argnames=("height", "width"))
def census_transform(image: jax.Array, height: int = 9, width: int = 9) -> jax.Array:
    """(B, H, W) image -> (B, H, W, n_words) uint32 packed census bits.

    Bit is set when the neighbour is strictly greater than the centre
    ("Census Center Function = Center", quick.param). Borders use edge
    replication (reference border policy is reflective; the difference is
    confined to the (h//2, w//2) frame).
    """
    batched = image.ndim == 3
    img = image if batched else image[None]
    img = img.astype(jnp.float32)
    ph, pw = height // 2, width // 2
    padded = jnp.pad(img, ((0, 0), (ph, ph), (pw, pw)), mode="edge")
    B, H, W = img.shape

    offs = _window_offsets(height, width)
    n_words = (len(offs) + 31) // 32
    words = []
    bit_idx = 0
    word = jnp.zeros((B, H, W), dtype=jnp.uint32)
    for dy, dx in offs:
        nb = jax.lax.dynamic_slice(padded, (0, dy + ph, dx + pw), (B, H, W))
        bit = (nb > img).astype(jnp.uint32)
        word = word | (bit << jnp.uint32(bit_idx))
        bit_idx += 1
        if bit_idx == 32:
            words.append(word)
            word = jnp.zeros((B, H, W), dtype=jnp.uint32)
            bit_idx = 0
    if bit_idx:
        words.append(word)
    out = jnp.stack(words, axis=-1)
    assert out.shape[-1] == n_words
    return out if batched else out[0]


@partial(jax.jit, static_argnames=("min_disparity", "disparity_range"))
def census_cost_volume(left_census: jax.Array, right_census: jax.Array,
                       min_disparity: int, disparity_range: int) -> tuple[jax.Array, jax.Array]:
    """Hamming cost volume from packed census images.

    Returns ``(C, valid)`` with C: (B, H, W, D) float32, and valid the
    in-image mask for each (x, d) pairing (right pixel x-d inside image).
    Invalid entries get BIG_COST so SGM/WTA never select them.
    """
    Rg, valid = gather_disparity_shifted(right_census, min_disparity, disparity_range)
    # left (B,H,W,1,nw) vs gathered right (B,H,W,D,nw)
    x = jnp.bitwise_xor(left_census[..., None, :], Rg)
    ham = jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.float32)
    C = jnp.where(valid, ham, BIG_COST)
    return C, valid
