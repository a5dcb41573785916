"""Sharded matching: SPMD SGM over a (data x spatial) mesh.

Frames are split over the ``data`` axis; image rows over ``spatial``.
Row-sharding needs context across the cut for (a) window ops (census /
box windows) and (b) the vertical/diagonal SGM path recurrences. Both
are handled with a **halo exchange**: each device ships its edge rows to
its spatial neighbours (`jax.lax.ppermute`; NVLink joins every pair of
cards of a host at the same rate), computes on the extended block, and
crops. SGM path costs are a contraction toward local
evidence (the - min_k normalization bounds each step's influence), so a
halo of H rows makes cross-boundary error decay geometrically; tests
measure agreement with the unsharded reference away from boundaries.

This replaces the reference's intra-engine multi-GPU
("MultiGPU Implementation After DSI = true", ini/quick.param:126) and its
process-level pipeline parallelism (SURVEY.md §2.4).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from i3dr_stereo_tpu.config.params import MatcherConfig
from i3dr_stereo_tpu.dist.mesh import DATA_AXIS, SPATIAL_AXIS
from i3dr_stereo_tpu.matchers.base import MatchResult
from i3dr_stereo_tpu.matchers.registry import MATCHER_REGISTRY

try:  # jax >= 0.6 stable name
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map  # type: ignore


def _exchange_halo(x: jax.Array, halo: int, axis_name: str) -> jax.Array:
    """Extend (B, Hloc, W) with `halo` rows from each spatial neighbour.

    Boundary devices receive zeros (ppermute semantics), i.e. the image
    simply ends there — same as the unsharded image border.
    """
    n = jax.lax.axis_size(axis_name)
    if n == 1 or halo == 0:
        return x
    down = [(i, i + 1) for i in range(n - 1)]   # send towards larger index
    up = [(i + 1, i) for i in range(n - 1)]     # send towards smaller index
    from_above = jax.lax.ppermute(x[:, -halo:], axis_name, down)
    from_below = jax.lax.ppermute(x[:, :halo], axis_name, up)
    return jnp.concatenate([from_above, x, from_below], axis=1)


def _crop_halo(x: jax.Array, halo: int, axis_name: str):
    n = jax.lax.axis_size(axis_name)
    if n == 1 or halo == 0:
        return x
    return x[:, halo:-halo]


def make_sharded_matcher(cfg: MatcherConfig, mesh: Mesh, halo: int = 32
                         ) -> Callable[[jax.Array, jax.Array], MatchResult]:
    """Build a jitted (B, H, W) matcher sharded over the mesh.

    B must divide by mesh.shape[data], H by mesh.shape[spatial].
    """
    cfg = cfg.sanitize()
    impl = MATCHER_REGISTRY[cfg.algorithm]
    spec = P(DATA_AXIS, SPATIAL_AXIS, None)

    # check_vma=False: the Pallas SGM kernel's interpreter (tests,
    # rehearsals) cannot mix the per-device costs with its unvarying
    # index arithmetic under the varying-axes check
    @partial(shard_map, mesh=mesh, in_specs=(spec, spec),
             out_specs=(spec, spec), check_vma=False)
    def fn(l, r):
        le = _exchange_halo(l, halo, SPATIAL_AXIS)
        re_ = _exchange_halo(r, halo, SPATIAL_AXIS)
        res = impl(le, re_, cfg)
        return (_crop_halo(res.disparity, halo, SPATIAL_AXIS),
                _crop_halo(res.valid, halo, SPATIAL_AXIS))

    @jax.jit
    def matched(l, r):
        d, v = fn(l, r)
        return MatchResult(disparity=d, valid=v)

    return matched


def make_sharded_pipeline_step(rig, cfg: MatcherConfig, cloud, mesh: Mesh,
                               halo: int = 32):
    """Full fused step over the mesh: rectify (data-sharded, full rows) ->
    sharded match (data x spatial + halo) -> depth (elementwise, sharded).

    Rectification gathers cross arbitrary rows (lens distortion), so it
    runs before the spatial split; XLA inserts the reshard between the
    stages (an all-to-all within each data shard). The rectify maps and
    Q ride as arguments of the jitted step, not closure constants: baked
    in, they are ~200 MB of constants at full resolution.
    """
    from i3dr_stereo_tpu.ops.depth import disparity_to_depth
    from i3dr_stereo_tpu.ops.rectify import make_rectify_map, remap

    cfg = cfg.sanitize()
    lmap = make_rectify_map(rig.left, interpolation="linear")
    rmap = make_rectify_map(rig.right, interpolation="linear")
    Q = jnp.asarray(rig.Q, dtype=jnp.float32)
    match = make_sharded_matcher(cfg, mesh, halo)
    data_only = NamedSharding(mesh, P(DATA_AXIS, None, None))
    rowsharded = NamedSharding(mesh, P(DATA_AXIS, SPATIAL_AXIS, None))

    @jax.jit
    def _step(left, right, lmap, rmap, Q):
        left = jax.lax.with_sharding_constraint(left, data_only)
        right = jax.lax.with_sharding_constraint(right, data_only)
        l = remap(left, lmap)
        r = remap(right, rmap)
        l = jax.lax.with_sharding_constraint(l, rowsharded)
        r = jax.lax.with_sharding_constraint(r, rowsharded)
        res = match(l, r)
        depth, dvalid = disparity_to_depth(res.disparity, res.valid, Q,
                                           cloud.depth_min, cloud.depth_max)
        return {
            "rect_left": l,
            "rect_right": r,
            "disparity": res.disparity,
            "valid": res.valid,
            "depth": depth,
            "depth_valid": dvalid,
        }

    def step(left, right):
        return _step(left, right, lmap, rmap, Q)

    return step
