"""Weak-scaling harness: particle pushes/s at fixed per-device load over an
increasing device count (BASELINE.json target: >=80% weak-scaling efficiency
to N hosts).

For each n in the device-count list (default: 1, 2, 4, ... up to all
available), builds an n-device particle-parallel mesh, loads
n * PIC1DP_WS_NPER markers, and times the sharded RK2 step by the scan-length
slope method (k vs 3k steps; excludes the dispatch latency).  Per-device
work is constant, so ideal scaling is flat pushes/s/device; the per-step
communication is two (2, nmode)-scalar psums regardless of n or nx (pinned by
tests/test_parallel.py::test_sharded_step_communicates_only_mode_scalars).

Prints one JSON line per device count plus a summary line:
    {"metric": "weak_scaling_efficiency", "value": eff_at_max_n, ...}

With PIC1DP_WS_CPU=1 the rows come from the virtual CPU mesh — that
validates the sharded compile/execute path end-to-end, but the virtual
devices share host cores, so CPU "efficiency" is a plumbing check, not a
hardware number.

Env knobs: PIC1DP_WS_NPER (markers per device, default 2**22),
PIC1DP_WS_STEPS (slope base k, default 5), PIC1DP_WS_DEVICES ("1,2,4"),
PIC1DP_WS_NX (1024), PIC1DP_WS_CPU=1.
"""

from __future__ import annotations

import json
import os
import sys
import time

# python bench/weak_scaling.py puts bench/ on sys.path, not the repo root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> None:
    n_per = int(os.environ.get("PIC1DP_WS_NPER", 2**22))
    steps = int(os.environ.get("PIC1DP_WS_STEPS", 5))
    nx = int(os.environ.get("PIC1DP_WS_NX", 1024))

    if os.environ.get("PIC1DP_WS_CPU"):
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8")

    import jax

    if os.environ.get("PIC1DP_WS_CPU"):
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from pic1dp_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()

    from pic1dp_tpu.config import bump_on_tail_default
    from pic1dp_tpu.core.loading import load_particles
    from pic1dp_tpu.parallel import mesh as pmesh

    avail = len(jax.devices())
    if os.environ.get("PIC1DP_WS_DEVICES"):
        counts = [int(c) for c in os.environ["PIC1DP_WS_DEVICES"].split(",")]
    else:
        counts, c = [], 1
        while c <= avail:
            counts.append(c)
            c *= 2
    counts = [c for c in counts if c <= avail]
    dev = jax.devices()[0]
    log(f"platform {dev.platform}:{dev.device_kind}, {avail} device(s); "
        f"counts={counts}, {n_per:.2e} markers/device, nx={nx}")

    rows = []
    for n_dev in counts:
        n = n_per * n_dev
        cfg = bump_on_tail_default(
            nx=nx, nparticle_max=n, dtype="float32", verbosity=0)
        mesh = pmesh.make_mesh(n_dev)
        stepper = pmesh.ShardedStepper(cfg, mesh)

        state = pmesh.shard_state(load_particles(cfg, jax.random.PRNGKey(7)),
                                  mesh)
        state = stepper.initial_field(state)

        multi_a = stepper.make_multi_step(steps)
        multi_b = stepper.make_multi_step(3 * steps)
        t0 = time.perf_counter()
        np.asarray(multi_a(state).electric)
        log(f"n={n_dev}: first {steps}-step scan (compile+run) "
            f"{time.perf_counter() - t0:.1f}s")
        np.asarray(multi_b(state).electric)

        # per-side minima (robust to additive latency hiccups; see bench.py)
        tas, tbs = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            np.asarray(multi_a(state).electric)
            tas.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            np.asarray(multi_b(state).electric)
            tbs.append(time.perf_counter() - t0)
        elapsed = (min(tbs) - min(tas)) / 2

        rate = 2.0 * n * steps / elapsed          # 2 RK substeps per step
        per_dev = rate / n_dev
        rows.append((n_dev, rate, per_dev))
        print(json.dumps({
            "metric": "weak_scaling_pushes_per_sec",
            "devices": n_dev,
            "value": rate,
            "per_device": per_dev,
            "unit": "pushes/s",
        }), flush=True)

    base = rows[0][2]
    eff = rows[-1][2] / base
    print(json.dumps({
        "metric": "weak_scaling_efficiency",
        "value": eff,
        "unit": f"per-device rate at n={rows[-1][0]} / n=1",
        "platform": dev.platform,
    }), flush=True)


if __name__ == "__main__":
    main()
