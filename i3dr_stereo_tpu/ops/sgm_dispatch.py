"""The one backend choice for SGM aggregation.

- On a GPU: the Pallas kernel (:mod:`i3dr_stereo_tpu.ops.sgm_triton`).
- On the CPU: the plain XLA reference (:mod:`i3dr_stereo_tpu.ops.sgm`).
- ``I3DR_SGM_BACKEND=xla`` forces the reference anywhere;
  ``I3DR_SGM_BACKEND=triton`` asks for the kernel and fails where the
  platform has none; ``triton_interpret`` runs the kernel through the
  Pallas interpreter on any platform, for tests and rehearsals only.
  ``auto`` (the default) picks by platform.

The choice is made in Python at trace time. There is no silent fallback:
an unknown backend name, or the kernel on a platform without it, raises.
Both implementations are bit-identical (tests and ``chip_smoke.py``).
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import jax

from i3dr_stereo_tpu.ops.sgm import DIRECTIONS_8, sgm_aggregate

BACKENDS = ("auto", "xla", "triton", "triton_interpret")
# platforms the kernel is compiled for
KERNEL_PLATFORMS = ("gpu",)


def resolve_backend(platform: str | None = None) -> str:
    """The backend that runs on ``platform`` (default: JAX's default)."""
    b = os.environ.get("I3DR_SGM_BACKEND", "auto")
    if b not in BACKENDS:
        raise ValueError(f"I3DR_SGM_BACKEND={b!r}; expected one of {BACKENDS}")
    if platform is None:
        platform = jax.default_backend()
    if b == "auto":
        b = "triton" if platform == "gpu" else "xla"
    if b == "triton" and platform not in KERNEL_PLATFORMS:
        raise RuntimeError(f"the SGM kernel has no build for platform "
                           f"{platform!r}; set I3DR_SGM_BACKEND=xla")
    return b


def sgm_aggregate_auto(C, p1: float = 10.0, p2: float = 120.0,
                       directions: Sequence[Tuple[int, int]] = DIRECTIONS_8,
                       per_direction_penalties=None):
    directions = tuple(tuple(d) for d in directions)
    pens = (None if per_direction_penalties is None
            else tuple(tuple(p) for p in per_direction_penalties))
    backend = resolve_backend()
    if backend != "xla":
        from i3dr_stereo_tpu.ops.sgm_triton import sgm_aggregate_triton

        return sgm_aggregate_triton(C, p1, p2, directions, pens,
                                    interpret=backend == "triton_interpret")
    return sgm_aggregate(C, p1, p2, directions, per_direction_penalties=pens)
