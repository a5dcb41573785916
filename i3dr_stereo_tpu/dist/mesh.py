"""Device mesh construction for the stereo engine.

The reference scales by multi-process pipelining and the licensed
engine's multi-GPU switch ("Indices Of GPUs In Stereo Matching",
"MultiGPU Implementation After DSI", ini/quick.param:14,126). The
model here is a 2D `jax.sharding.Mesh`:

- ``data``   — frame/batch parallelism (independent stereo pairs),
- ``spatial``— image-row parallelism within a frame, with halo exchange
  for the SGM paths that cross tile boundaries (the CP/ring analog of
  SURVEY.md §2.4).

Collectives run between the cards of a host (NVLink, all to all, so the
mesh shape follows the algorithm alone); multi-host ingest happens at
the host shell, never inside the compiled step.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a (data x spatial) mesh from the available devices.

    Defaults: all devices on the data axis. n_data=None infers
    len(devices) // n_spatial.
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = len(devices) // n_spatial
    need = n_data * n_spatial
    if need > len(devices):
        raise ValueError(f"mesh {n_data}x{n_spatial} needs {need} devices, "
                         f"have {len(devices)}")
    grid = np.array(devices[:need]).reshape(n_data, n_spatial)
    return Mesh(grid, (DATA_AXIS, SPATIAL_AXIS))


def batch_sharding(mesh: Mesh, *, spatial: bool = False) -> NamedSharding:
    """(B, H, W) arrays: batch over data, optionally rows over spatial."""
    return NamedSharding(mesh, P(DATA_AXIS, SPATIAL_AXIS if spatial else None, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
