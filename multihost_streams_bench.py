"""BASELINE config 5 in miniature.

"Multi-host: 4 stereo streams x 1000-tile batches, throughput +
collectives" (BASELINE.md config 5) exercised at CI scale on a REAL
2-process `jax.distributed` rig (4 virtual CPU devices per process, the
same code path a multi-host deployment runs): 4 concurrent stereo streams, each
batching one tile per global device, sharing the mesh round-robin, with
a cross-host valid-count all-reduce per batch. Per-stream throughput and
accuracy are recorded per row.

Run from the repository root (the workers exchange results through
out.json, by default multihost_streams.json in the temp directory):
    python multihost_streams_bench.py [out.json]
"""

import json
import os
import socket
import subprocess
import sys


def _run_pass(out_path: str, nprocs: int, timeout: float) -> dict:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()

    here = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(here, "tests", "_multihost_streams_worker.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    procs = [subprocess.Popen(
        [sys.executable, worker, str(i), str(port), out_path, str(nprocs)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for i in range(nprocs)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode != 0:
            raise RuntimeError(
                f"worker failed rc={p.returncode}: {err.decode()[-2000:]}")
    with open(out_path) as f:
        return json.load(f)


def run(out_path: str | None = None, timeout: float = 300.0) -> dict:
    if out_path is None:
        import tempfile

        out_path = os.path.join(tempfile.gettempdir(), "multihost_streams.json")
    doc = _run_pass(out_path, 2, timeout)
    # 1->2 host WEAK-SCALING point (BASELINE metric 3 at miniature
    # scale): the same per-device workload on a 1-process 4-device mesh
    # vs the 2-process 8-device mesh; efficiency = per-device throughput
    # ratio. Honest caveat: virtual CPU devices share physical cores, so
    # this validates the code path + collective overhead, not the
    # efficiency of real devices (the CPU mesh is core-bounded).
    one = _run_pass(out_path + ".1proc", 1, timeout)
    try:
        os.remove(out_path + ".1proc")
    except OSError:
        pass
    eff = (doc["tiles_per_s_per_device"]
           / max(one["tiles_per_s_per_device"], 1e-9))
    doc["weak_scaling_1to2_hosts"] = {
        "tiles_per_s_per_device_1proc_4dev": one["tiles_per_s_per_device"],
        "tiles_per_s_per_device_2proc_8dev": doc["tiles_per_s_per_device"],
        "efficiency": round(eff, 3),
        "note": "REAL 2-process jax.distributed path; virtual CPU "
                "devices share host cores, so this measures code-path "
                "+ collective overhead, not interconnect bandwidth",
    }
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps(doc))
    return doc


if __name__ == "__main__":
    run(*sys.argv[1:2])
