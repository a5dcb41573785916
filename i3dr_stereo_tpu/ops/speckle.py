"""Speckle filtering: invalidate small disconnected disparity regions.

Equivalent of cv::filterSpeckles (used by the reference's BM/SGBM
backends via speckle_size/speckle_range, cfg/i3DR_Disparity.cfg:33-34)
and the engine's "Disparity Speckle Filter Max Difference = 0.5 / Max
Region Size = 100" (ini/quick.param:94-95).

Data-parallel formulation — a scatter-free labelling phase. Serial
flood fill doesn't exist under XLA, and pointer-jumping label
propagation costs one full gather per iteration. Instead:

1. **Local min-label propagation only** (pure vector shifts): L
   iterations over the 4-connected, |Δd| <= max_diff graph. L =
   max_size + margin, because any *removable* region (size <= S) has
   diameter < S and converges exactly within S iterations.
2. **Exactness for big regions** without global convergence: pixels of
   a region that has not converged must be kept (its true size exceeds
   S — if any pixel were farther than L >= S hops away, the connecting
   geodesic alone has > S distinct pixels). Detection: a region is
   unconverged iff it still changes labels; any change in the last
   iterations seeds a **dirty flag**, propagated along the same
   connectivity (cheap boolean ORs). Min-propagation makes strict
   progress next to every label catchment each round, and a catchment's
   diameter is <= 2L, so 2L+4 dirty rounds reach every pixel of every
   unconverged region. Converged regions see no changes and no dirty
   leak-in (dirtiness travels only along region edges).
3. **One** scatter-add histogram of the final labels + **one** gather
   gives exact counts for converged regions.

keep = valid & (dirty | count > max_size) then reproduces
cv::filterSpeckles exactly (tests/test_ops.py holds it to the cv2
oracle).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _neighbor_shift(x: jax.Array, dy: int, dx: int, fill) -> jax.Array:
    pad = [(0, 0)] * x.ndim
    idx = [slice(None)] * x.ndim
    ay, ax_ = x.ndim - 2, x.ndim - 1
    H, W = x.shape[-2], x.shape[-1]
    pad[ay] = (max(dy, 0), max(-dy, 0))
    pad[ax_] = (max(dx, 0), max(-dx, 0))
    idx[ay] = slice(max(-dy, 0), max(-dy, 0) + H)
    idx[ax_] = slice(max(-dx, 0), max(-dx, 0) + W)
    return jnp.pad(x, pad, constant_values=fill)[tuple(idx)]


_NEIGH = ((1, 0), (-1, 0), (0, 1), (0, -1))


@partial(jax.jit, static_argnames=("max_size", "iters", "downsample"))
def speckle_filter(disp: jax.Array, valid: jax.Array, *,
                   max_size: int = 100, max_diff: float = 1.0,
                   iters: int = 0, downsample: int = 1) -> jax.Array:
    """Return the updated valid mask with speckles removed.

    disp: (H, W) or (B, H, W) float disparities; valid: same-shape bool.
    ``iters`` overrides the propagation budget (0 = exact: max_size+2).

    ``downsample`` > 1 runs the labelling on a strided subsample (size
    threshold scaled by downsample^2) and broadcasts the verdict back —
    ~downsample^2 x cheaper; regions near the threshold may be judged
    slightly differently (the reference engine similarly speckle-filters
    at pyramid scales, ini/quick.param per-level sections).
    """
    if max_size <= 0:
        return valid
    if downsample > 1:
        # block-reduce subsample: each kxk block is represented by its
        # min valid disparity, and the verdict is broadcast back.
        k = downsample
        batched = disp.ndim == 3
        d3 = disp if batched else disp[None]
        v3 = valid if batched else valid[None]
        B, H, W = d3.shape
        H2, W2 = -(-H // k), -(-W // k)
        pH, pW = H2 * k - H, W2 * k - W
        d3p = jnp.pad(d3.astype(jnp.float32), ((0, 0), (0, pH), (0, pW)))
        v3p = jnp.pad(v3, ((0, 0), (0, pH), (0, pW)))
        # two single-axis reductions: along x, then along y
        masked = jnp.where(v3p, d3p, jnp.inf)
        dd = masked.reshape(B, H2 * k, W2, k).min(-1)
        dd = dd.reshape(B, H2, k, W2).min(2)
        vv = v3p.reshape(B, H2 * k, W2, k).any(-1)
        vv = vv.reshape(B, H2, k, W2).any(2)
        keep_small = speckle_filter(dd, vv,
                                    max_size=max(max_size // (k * k), 1),
                                    max_diff=max_diff * k,
                                    iters=iters, downsample=1)
        rejected = vv & ~keep_small
        rej_full = jnp.broadcast_to(rejected[:, :, None, :, None],
                                    (B, H2, k, W2, k)).reshape(B, H2 * k,
                                                               W2 * k)
        keep = v3 & ~rej_full[:, :H, :W]
        return keep if batched else keep[0]
    batched = disp.ndim == 3
    d = (disp if batched else disp[None]).astype(jnp.float32)
    v = valid if batched else valid[None]
    B, H, W = d.shape
    INF_LABEL = jnp.int32(H * W)
    L = iters if iters > 0 else max_size + 2

    flat_ids = (jnp.arange(H * W, dtype=jnp.int32).reshape(1, H, W)
                .repeat(B, axis=0))
    label = jnp.where(v, flat_ids, INF_LABEL)

    # 4-neighbour connectivity under the |Δd| <= max_diff rule
    conn = []
    for dy, dx in _NEIGH:
        nd = _neighbor_shift(d, dy, dx, jnp.inf)
        nv = _neighbor_shift(v, dy, dx, False)
        conn.append(v & nv & (jnp.abs(d - nd) <= max_diff))

    def prop(lab):
        for (dy, dx), m in zip(_NEIGH, conn):
            nl = _neighbor_shift(lab, dy, dx, INF_LABEL)
            lab = jnp.minimum(lab, jnp.where(m, nl, INF_LABEL))
        return lab

    label = jax.lax.fori_loop(0, L, lambda _, lab: prop(lab), label)

    # change-detection window: unconverged regions keep making progress
    dirty = jnp.zeros((B, H, W), dtype=bool)
    for _ in range(3):
        nxt = prop(label)
        dirty = dirty | (nxt != label)
        label = nxt

    # dirty spreads along region edges: diam(catchment) <= 2L, +margin
    def spread(dt):
        for (dy, dx), m in zip(_NEIGH, conn):
            dt = dt | (m & _neighbor_shift(dt, dy, dx, False))
        return dt

    P = 2 * L + 4
    dirty = jax.lax.fori_loop(0, P, lambda _, dt: spread(dt), dirty)

    # exact sizes of (converged) components: one histogram + one lookup
    lab_flat = label.reshape(B, H * W)
    ones = jnp.where(lab_flat < INF_LABEL, 1, 0)
    safe = jnp.clip(lab_flat, 0, H * W - 1)
    counts = jnp.zeros((B, H * W), dtype=jnp.int32)
    counts = jax.vmap(lambda c, s, o: c.at[s].add(o))(counts, safe, ones)
    size = jnp.take_along_axis(counts, safe, axis=1).reshape(B, H, W)

    keep = v & (dirty | (size > max_size))
    return keep if batched else keep[0]
