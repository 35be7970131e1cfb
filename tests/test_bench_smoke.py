"""bench.py end-to-end smoke on CPU: a regression in the harness (not just
in the kernels it times) must fail the suite.

Tiny sizes; asserts the ONE-JSON-line contract and the required fields,
including the device the rates were measured on."""

import json
import os
import subprocess
import sys


def test_bench_cpu_smoke():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ,
           "PIC1DP_BENCH_CPU": "1",
           "PIC1DP_BENCH_N": "32768",
           "PIC1DP_BENCH_NX": "64",
           "PIC1DP_BENCH_STEPS": "2",
           "PIC1DP_BENCH_SPMV_ITERS": "1"}
    out = subprocess.run([sys.executable, os.path.join(repo, "bench.py")],
                         env=env, cwd=repo, capture_output=True, text=True,
                         timeout=540)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, lines  # the driver contract: ONE JSON line
    payload = json.loads(lines[0])
    assert payload["metric"] == "particles_pushed_per_sec_per_chip"
    assert payload["device"] == {"platform": "cpu", "kind": "cpu",
                                 "count": payload["device"]["count"]}
    assert payload["value"] > 0
    assert payload["unit"] == "pushes/s"
    assert payload["vs_baseline"] > 0
    assert len(payload["spread_rates"]) == 3
    assert 0.0 <= payload["spread_rel"] < 1.0
    assert payload["deposit_nnz_per_sec"] > 0
    assert payload["gather_nnz_per_sec"] > 0
