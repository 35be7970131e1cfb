"""Worker for the multi-process weak-scaling row.

Each worker process owns `devices_per_proc` virtual CPU devices; the global
1-D particle mesh spans nprocs * devices_per_proc devices, so with nprocs=2
the per-step mode-projection psums cross a REAL process boundary through the
jax.distributed runtime — a stand-in for the hop between hosts (reference
equivalent: the default 4-rank mpiexec run, run/Makefile:38-48).

Times the production sharded multi-step scan by the two-point slope method
and prints one JSON rate line from process 0.  Launched pairwise by
bench/weak_scaling_artifact.py; nprocs=1 runs the same code single-process
(the equal-work, equal-device-count control).

Usage: python bench/weak_scaling_worker.py <proc> <nprocs> <port>
           <devices_per_proc> <nper> <steps>
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

proc = int(sys.argv[1])
nprocs = int(sys.argv[2])
port = sys.argv[3]
dev_per_proc = int(sys.argv[4])
n_per_dev = int(sys.argv[5])
steps = int(sys.argv[6])

os.environ["XLA_FLAGS"] = (
    f"--xla_force_host_platform_device_count={dev_per_proc}")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from pic1dp_tpu.parallel import launch  # noqa: E402

if nprocs > 1:
    launch.initialize(coordinator_address=f"127.0.0.1:{port}",
                      num_processes=nprocs, process_id=proc)

import numpy as np  # noqa: E402

from pic1dp_tpu.config import bump_on_tail_default  # noqa: E402
from pic1dp_tpu.core.loading import load_particles  # noqa: E402
from pic1dp_tpu.parallel import mesh as pmesh  # noqa: E402

n_dev = nprocs * dev_per_proc
assert jax.device_count() == n_dev, (jax.device_count(), n_dev)

n_total = n_per_dev * n_dev
cfg = bump_on_tail_default(nx=int(os.environ.get("PIC1DP_WS_NX", 256)),
                           nparticle_max=n_total, dtype="float32",
                           verbosity=0)
mesh = launch.global_mesh()
stepper = pmesh.ShardedStepper(cfg, mesh)
state = pmesh.shard_state(load_particles(cfg, jax.random.PRNGKey(7)), mesh)
state = stepper.initial_field(state)

multi_a = stepper.make_multi_step(steps)
multi_b = stepper.make_multi_step(3 * steps)
np.asarray(multi_a(state).electric)
np.asarray(multi_b(state).electric)

tas, tbs = [], []
for _ in range(3):
    t0 = time.perf_counter()
    np.asarray(multi_a(state).electric)
    tas.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    np.asarray(multi_b(state).electric)
    tbs.append(time.perf_counter() - t0)
elapsed = max((min(tbs) - min(tas)) / 2, 1e-30)
rate = 2.0 * n_total * steps / elapsed

if proc == 0:
    print(json.dumps({
        "metric": "weak_scaling_pushes_per_sec",
        "processes": nprocs,
        "devices": n_dev,
        "per_device_markers": n_per_dev,
        "value": rate,
        "per_device": rate / n_dev,
        "unit": "pushes/s",
    }), flush=True)
