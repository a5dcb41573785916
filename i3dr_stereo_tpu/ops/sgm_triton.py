"""SGM path aggregation as a Pallas kernel for NVIDIA GPUs (Triton route).

Same contract as the plain reference :func:`i3dr_stereo_tpu.ops.sgm.sgm_aggregate`
(float32 (B, H, W, D) costs in, the sum of L_r over the requested
directions out, per-direction (P1, P2), zero carry where a path enters
the image) and bit-identical to it: the kernel evaluates the same float32
operations in the same order.

Layout, after the GPU design of Hernandez-Juarez et al. (arXiv
1610.04121): one kernel launch per direction. Each program owns ``R``
independent scanlines (rows for horizontal paths, columns for vertical
ones, diagonal lines x - s*y = const for diagonal ones) and walks along
them, keeping the recurrence carry on chip; the disparity axis sits
inside the program, padded to a power of two by masking. One scanline
per program, in one warp, was fastest on an H100 at both of
``chip_smoke.py``'s shapes (2 and 4 per program were slower). Diagonal lines
that run outside the image are masked and hold a zero carry until they
enter it.

The d-1 / d+1 neighbours of the carry need a cross-lane shift, which the
Triton route does not offer on register values. Each program therefore
writes its carry into a private scratch row and reads it back at offsets
-1 and +1 behind a block barrier: an exact permutation, no arithmetic.

Penalties are runtime operands, so live reconfigure does not recompile.
The launch that handles a direction accumulates into the running sum in
place (``input_output_aliases``), in the reference's direction order.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from i3dr_stereo_tpu.ops.sgm import BIG, DIRECTIONS_8

R = 1  # scanlines per program


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def _geometry(H: int, W: int, dy: int, dx: int):
    """(number of scanlines, steps along each) for one direction."""
    if dy == 0:
        return H, W
    if dx == 0:
        return W, H
    return H + W - 1, H


def _direction_kernel(pen_ref, c_ref, s_in_ref, s_ref, scr_ref, *,
                      B: int, H: int, W: int, D: int, Dp: int,
                      dy: int, dx: int, first: bool, interpret: bool):
    del s_in_ref  # aliased with s_ref
    b = pl.program_id(0)
    blk = pl.program_id(1)
    n_lines, n_steps = _geometry(H, W, dy, dx)
    n_blocks = -(-n_lines // R)
    N = B * H * W  # rows of the flattened (B*H*W, D) volume

    line = blk * R + jnp.arange(R, dtype=jnp.int32)
    line_ok = line < n_lines
    d = jnp.arange(Dp, dtype=jnp.int32)
    d_ok = (d < D)[None, :]
    # this program's private carry rows in the scratch buffer
    srow = ((b * n_blocks + blk) * R
            + jnp.arange(R, dtype=jnp.int32))[:, None]
    dcol = d[None, :]

    p1 = pen_ref[0]
    p2 = pen_ref[1]
    big = jnp.float32(BIG)
    s = dx * dy  # diagonal lines: x - s*y = const
    j_lo = -(H - 1) if s > 0 else 0

    def sync():
        if not interpret:
            plgpu.debug_barrier()

    def coords(t):
        """Flat volume row of each line at step t (N where outside)."""
        if dy == 0:
            x = t if dx > 0 else W - 1 - t
            y = line
            ok = line_ok
        else:
            y = t if dy > 0 else H - 1 - t
            x = line if dx == 0 else j_lo + line + s * y
            ok = line_ok & (x >= 0) & (x < W)
        pos = jnp.where(ok, (b * H + y) * W + x, N)
        return pos[:, None], ok[:, None]

    def load_c(t):
        pos, ok = coords(t)
        return plgpu.load(c_ref.at[pos, dcol], mask=ok & d_ok, other=0.0)

    zero = jnp.zeros((R, Dp), jnp.float32)
    has_left = jnp.broadcast_to(dcol >= 1, (R, Dp))
    has_right = jnp.broadcast_to(dcol + 1 < D, (R, Dp))
    plgpu.store(scr_ref.at[srow, dcol], zero)
    sync()

    def body(t, carry):
        prev, c = carry
        # prefetch the next step's costs; they do not depend on the carry
        c_next = load_c(jnp.minimum(t + 1, n_steps - 1))
        left = plgpu.load(scr_ref.at[srow, dcol - 1], mask=has_left,
                          other=big)
        right = plgpu.load(scr_ref.at[srow, dcol + 1], mask=has_right,
                           other=big)
        m = jnp.min(jnp.where(d_ok, prev, jnp.inf), axis=1, keepdims=True)
        best = jnp.minimum(jnp.minimum(prev, m + p2),
                           jnp.minimum(left + p1, right + p1))
        pos, ok = coords(t)
        L = jnp.where(ok, c + best - m, 0.0)
        st_mask = ok & d_ok
        if first:
            plgpu.store(s_ref.at[pos, dcol], L, mask=st_mask)
        else:
            acc = plgpu.load(s_ref.at[pos, dcol], mask=st_mask, other=0.0)
            plgpu.store(s_ref.at[pos, dcol], acc + L, mask=st_mask)
        sync()  # every lane has read the old carry
        plgpu.store(scr_ref.at[srow, dcol], L)
        sync()  # the new carry is visible to every lane
        return L, c_next

    jax.lax.fori_loop(0, n_steps, body, (zero, load_c(0)))


def _aggregate_direction(pens, C2, S2, *, B, H, W, D, dy, dx, first,
                         interpret):
    Dp = _pow2_ceil(D)
    n_lines, _ = _geometry(H, W, dy, dx)
    n_blocks = -(-n_lines // R)
    kernel = partial(_direction_kernel, B=B, H=H, W=W, D=D, Dp=Dp,
                     dy=dy, dx=dx, first=first, interpret=interpret)
    S2, _ = pl.pallas_call(
        kernel,
        grid=(B, n_blocks),
        out_shape=(jax.ShapeDtypeStruct(S2.shape, jnp.float32),
                   jax.ShapeDtypeStruct((B * n_blocks * R, Dp), jnp.float32)),
        input_output_aliases={2: 0},
        # num_stages=1: no software pipelining, which could hoist the
        # scratch loads of the next step above this step's barrier
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        backend="triton",
        name=f"sgm_dir_{dy}_{dx}".replace("-", "m"),
    )(pens, C2, S2)
    return S2


@partial(jax.jit, static_argnames=("directions", "interpret"))
def _sgm_aggregate_triton(C, pens, directions, interpret):
    B, H, W, D = C.shape
    C2 = C.reshape(B * H * W, D)
    S2 = jnp.zeros_like(C2)
    for i, (dy, dx) in enumerate(directions):
        S2 = _aggregate_direction(pens[i], C2, S2, B=B, H=H, W=W, D=D,
                                  dy=dy, dx=dx, first=i == 0,
                                  interpret=interpret)
    return S2.reshape(B, H, W, D)


def sgm_aggregate_triton(C: jax.Array, p1=10.0, p2=120.0,
                         directions: Sequence[Tuple[int, int]] = DIRECTIONS_8,
                         per_direction_penalties=None, *,
                         interpret: bool = False) -> jax.Array:
    """Drop-in for :func:`i3dr_stereo_tpu.ops.sgm.sgm_aggregate` on a GPU.

    ``interpret=True`` runs the kernel through the Pallas interpreter
    (any backend; used by the CPU tests)."""
    directions = tuple(tuple(d) for d in directions)
    if per_direction_penalties is None:
        per_direction_penalties = ((p1, p2),) * len(directions)
    pens = jnp.stack([jnp.stack([jnp.asarray(a, jnp.float32),
                                 jnp.asarray(b, jnp.float32)])
                      for a, b in per_direction_penalties])
    batched = C.ndim == 4
    Cb = (C if batched else C[None]).astype(jnp.float32)
    S = _sgm_aggregate_triton(Cb, pens, directions, interpret)
    return S if batched else S[0]
