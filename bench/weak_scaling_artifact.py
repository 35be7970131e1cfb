"""Assemble a weak-scaling artifact (JSON).

Headline fields, in order of evidential weight:

  1. `equal_work_sharding_overhead` — an 8-virtual-device sharded run vs ONE
     device doing the SAME total work on the same host: isolates the cost of
     shard_map + the two per-step psums from batch-size effects (compute
     capacity is identical by construction).
  2. `two_process` — the same equal-device-count, equal-work comparison with
     the 4-device mesh split across TWO jax.distributed processes (2+2):
     the per-step mode-projection psums cross a real process boundary
     through the distributed runtime, a stand-in for the hop between
     hosts.
  3. `comm_cost_model` — the HLO-pinned communication budget that, combined
     with 1-2, is the weak-scaling argument for real multi-GPU meshes.
  4. `hardware_single_chip_pushes_per_sec` — the per-device rate a real mesh
     would weak-scale from (bench.py headline).

The raw virtual-CPU mesh rows (1..8 devices at fixed per-device load) are
kept LAST under `plumbing_virtual_mesh`: virtual devices share host cores,
so their per-device rate falls ~1/n BY CONSTRUCTION — no field named
"efficiency" is derived from them (the flat TOTAL rate is the only
plumbing signal in those rows).

Usage: python bench/weak_scaling_artifact.py --out weak_scaling.json
       [--device-rate PUSHES_PER_S]   (skip re-running bench.py on the GPU)
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def run_ws(env_extra):
    env = dict(os.environ, **env_extra)
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "weak_scaling.py")],
        capture_output=True, text=True, env=env, timeout=3600, check=True)
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]


def run_worker_pair(nprocs, dev_per_proc, nper, steps):
    """Launch bench/weak_scaling_worker.py nprocs times; return proc 0's
    rate row."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = os.path.join(HERE, "weak_scaling_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(i), str(nprocs), str(port),
         str(dev_per_proc), str(nper), str(steps)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(nprocs)]
    outs = [p.communicate(timeout=1800) for p in procs]
    for p, (_, stderr) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"worker failed rc={p.returncode}: "
                               f"{stderr[-2000:]}")
    lines = [ln for ln in outs[0][0].splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--device-rate", type=float, default=None,
                    help="single-chip pushes/s (skips running bench.py)")
    ap.add_argument("--nper", type=int, default=262144)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()

    virtual = run_ws({"PIC1DP_WS_CPU": "1", "PIC1DP_WS_NPER": str(args.nper)})
    equal_work = run_ws({
        "PIC1DP_WS_CPU": "1", "PIC1DP_WS_NPER": str(args.nper * 8),
        "PIC1DP_WS_DEVICES": "1"})

    cpu = [r for r in virtual if r["metric"] == "weak_scaling_pushes_per_sec"]
    total_1 = cpu[0]["value"]
    total_8 = cpu[-1]["value"]
    single_eq = equal_work[0]["value"]

    # two-process row: 4 devices in one process vs 4 devices across two
    # jax.distributed processes, SAME total work — the ratio is the cost of
    # routing the per-step psums through the distributed runtime
    row_1p = run_worker_pair(1, 4, args.nper, args.steps)
    row_2p = run_worker_pair(2, 2, args.nper, args.steps)

    if args.device_rate is None:
        env = dict(os.environ, PIC1DP_BENCH_SECONDARY="0")
        out = subprocess.run([sys.executable, os.path.join(REPO, "bench.py")],
                             capture_output=True, text=True, env=env,
                             timeout=3600, check=True)
        args.device_rate = json.loads(out.stdout.splitlines()[-1])["value"]

    artifact = {
        "equal_work_sharding_overhead": {
            "sharded_8dev_over_single_dev_equal_work": total_8 / single_eq,
            "note": ("8-device sharded rate / 1-device rate at IDENTICAL "
                     "total work and host compute: bounds shard_map + "
                     "2-psum overhead; ~1.0 = free"),
        },
        "two_process": {
            "control_1proc_4dev": row_1p,
            "distributed_2proc_4dev": row_2p,
            "cross_process_rate_ratio":
                row_2p["value"] / row_1p["value"],
            "note": ("same device count, same total work; the 2-process row "
                     "routes every per-step psum through jax.distributed "
                     "across a real process boundary (multi-host stand-in; "
                     "reference anchor: 4-rank mpiexec, run/Makefile:38-48)"),
        },
        "comm_cost_model": (
            "2 psums of (2, nmode) f32 scalars per RK2 step = 16*nmode B "
            "per device per step, independent of markers and nx (HLO-pinned "
            "by tests/test_parallel.py::"
            "test_sharded_step_communicates_only_mode_scalars); no "
            "bandwidth term, latency-only -> predicted weak-scaling "
            "efficiency > 99.9% at 2^26 markers/device"),
        "hardware_single_chip_pushes_per_sec": args.device_rate,
        "plumbing_virtual_mesh": {
            "rows": virtual,
            "equal_work_single_device_row": equal_work,
            "total_rate_1dev": total_1,
            "total_rate_8dev_8x_work": total_8,
            "total_rate_flatness_8x_work": total_8 / total_1,
            "note": (
                "virtual CPU devices share host cores, so per-device rate "
                "falls ~1/n BY CONSTRUCTION — no efficiency number is "
                "derived from these rows; flat TOTAL rate at 8x work = the "
                "sharded path adds no serial bottleneck"),
        },
    }
    with open(args.out, "w") as fh:
        json.dump(artifact, fh, indent=1)
    print(json.dumps({
        "metric": "weak_scaling_artifact", "out": args.out,
        "equal_work_overhead": total_8 / single_eq,
        "cross_process_ratio": row_2p["value"] / row_1p["value"],
        "total_rate_flatness": total_8 / total_1,
    }))


if __name__ == "__main__":
    main()
