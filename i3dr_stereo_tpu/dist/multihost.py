"""Multi-host ingest + scaling measurement.

Reference reality: one machine, many processes, GigE cameras with jumbo
frames (README.md:67-85). Here: each host process ingests its local
cameras' frames with host I/O, places them into the globally-sharded
batch with ``jax.make_array_from_process_local_data``, and the compiled
step runs SPMD over every device of every process — collectives inside,
no host hops on the hot path.

Also provides the scaling-efficiency harness for BASELINE config 5
(throughput at 1 device / N devices, efficiency = T_N / (N * T_1)).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from i3dr_stereo_tpu.dist.mesh import DATA_AXIS, SPATIAL_AXIS, make_mesh


def global_frame_batch(mesh: Mesh, local_left: np.ndarray,
                       local_right: np.ndarray):
    """Assemble the global (B_global, H, W) batch from this process's
    local frames. With one process this is a plain device_put with the
    batch sharding; with multiple hosts each process contributes its
    local shard (pixels never cross hosts — each feeds its own devices).
    """
    sharding = NamedSharding(mesh, P(DATA_AXIS, None, None))
    if jax.process_count() == 1:
        return (jax.device_put(local_left, sharding),
                jax.device_put(local_right, sharding))
    l = jax.make_array_from_process_local_data(sharding, local_left)
    r = jax.make_array_from_process_local_data(sharding, local_right)
    return l, r


def measure_scaling(step_factory: Callable[[Mesh], Callable],
                    make_batch: Callable[[int], tuple],
                    device_counts: List[int],
                    iters: int = 3) -> Dict[int, dict]:
    """Throughput at several mesh sizes; efficiency vs the smallest.

    step_factory(mesh) -> jitted step; make_batch(n_data) -> args with a
    batch divisible by n_data.
    """
    results: Dict[int, dict] = {}
    base = None
    for n in device_counts:
        if n > len(jax.devices()):
            continue
        mesh = make_mesh(n, 1)
        step = step_factory(mesh)
        args = make_batch(n)
        out = step(*args)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = step(*args)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / iters
        frames = args[0].shape[0]
        thr = frames / dt
        if base is None:
            base = (n, thr)
        eff = thr / (base[1] * n / base[0])
        results[n] = {"devices": n, "frames_per_s": thr,
                      "efficiency": eff}
    return results
