"""Benchmark harness: particles pushed/sec/chip on the scaled bump-on-tail
case (BASELINE.json config 4: 1024 cells, delta-f weights, single chip).

Prints ONE JSON line:
    {"metric": "particles_pushed_per_sec_per_chip", "value": ..., "unit":
     "pushes/s", "vs_baseline": ...}

"vs_baseline" divides by an estimate of the Fortran+PETSc reference on one
host (its default 4 MPI ranks, Makefile:38-39).  The reference publishes no
numbers and cannot be built here (no mpif90/PETSc), so the stand-in is
bench/baseline_push.cpp: the reference's serial per-rank hot loop
(gather/push/deposit semantics of src/pic1dp_interaction.F90) in C++ -O3,
single-core rate x 4 ranks.  Because the live measurement swings +-30% with
host load, "vs_baseline" uses the pinned best-of-history stand-in rate
(PINNED_BASELINE below) and "vs_baseline_live" the rate measured at bench
time (falling back to 8.0e7 pushes/s if g++ is unavailable).

Secondary metrics (deposition nnz/s, Poisson-solve us/step, per-phase table)
go to stderr.

Env knobs: PIC1DP_BENCH_N (markers, default 2**26), PIC1DP_BENCH_NX (1024),
PIC1DP_BENCH_STEPS (10).  The bench needs a GPU; PIC1DP_BENCH_CPU=1 is the
only way to run it elsewhere (a CPU rehearsal of the control flow, whose
rates are not device numbers).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

FALLBACK_BASELINE = 8.0e7  # pushes/s, one host: ~2e7/core x 4 ranks
REF_RANKS = 4

# Best-of-history C++ stand-in rate (pushes/s/core): the live measurement
# swings +-30% with host load, which made vs_baseline denominator noise.
# The pinned value is the fastest rate measured on an idle host (best of
# 3), i.e. the most conservative denominator; "vs_baseline" in the JSON
# uses it, "vs_baseline_live" carries the rerun-at-bench-time ratio.
PINNED_BASELINE_PER_CORE = 5.108e7
PINNED_BASELINE = PINNED_BASELINE_PER_CORE * REF_RANKS


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def measure_baseline() -> float:
    """Single-host Fortran+PETSc stand-in (see module docstring)."""
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "bench", "baseline_push.cpp")
    exe = os.path.join(here, "bench", "baseline_push")
    try:
        if not os.path.exists(exe) or os.path.getmtime(exe) < os.path.getmtime(src):
            subprocess.run(["g++", "-O3", "-march=native", "-o", exe, src],
                           check=True, capture_output=True, timeout=120)
        per_core = max(
            float(subprocess.run([exe, "2000000", "192", "10"], check=True,
                                 capture_output=True, timeout=300,
                                 text=True).stdout.strip())
            for _ in range(3))  # best-of-3: machine-noise-free upper bound
        log(f"baseline: C++ hot loop {per_core:.3e} pushes/s/core "
            f"x {REF_RANKS} ranks (best of 3)")
        return per_core * REF_RANKS
    except Exception as e:  # noqa: BLE001 — any failure -> documented constant
        log(f"baseline: measurement failed ({e!r}); using fallback "
            f"{FALLBACK_BASELINE:.1e}")
        return FALLBACK_BASELINE


def main() -> None:
    n = int(os.environ.get("PIC1DP_BENCH_N", 2**26))
    nx = int(os.environ.get("PIC1DP_BENCH_NX", 1024))
    steps = int(os.environ.get("PIC1DP_BENCH_STEPS", 10))

    baseline = measure_baseline()

    import jax

    if os.environ.get("PIC1DP_BENCH_CPU"):
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from pic1dp_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()

    from pic1dp_tpu.config import bump_on_tail_default
    from pic1dp_tpu.core.loading import load_particles
    from pic1dp_tpu.core.step import Stepper

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not os.environ.get("PIC1DP_BENCH_CPU"):
        raise SystemExit(f"bench.py needs a GPU (JAX's first device is "
                         f"{dev.platform}); PIC1DP_BENCH_CPU=1 rehearses "
                         "on the CPU")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    nmode_env = os.environ.get("PIC1DP_BENCH_NMODE", "1")
    log(f"device: {dev.platform}:{dev.device_kind}  n={n:.2e} nx={nx} "
        f"steps={steps} nmode={nmode_env}")

    from pic1dp_tpu.config import DepositMethod

    method = DepositMethod(os.environ.get("PIC1DP_BENCH_METHOD", "auto"))
    nmode = int(os.environ.get("PIC1DP_BENCH_NMODE", 1))
    cfg = bump_on_tail_default(
        nx=nx,
        nparticle_max=n,
        dtype="float32",
        deposit_method=method,
        deposit_chunk=int(os.environ.get("PIC1DP_BENCH_CHUNK", 65536)),
        modes=tuple(range(1, nmode + 1)),
        verbosity=0,
    )
    stepper = Stepper(cfg)

    t0 = time.perf_counter()
    state = load_particles(cfg, jax.random.PRNGKey(12345))
    state = stepper.initial_field(state)
    jax.block_until_ready(state.electric)
    log(f"load+initial solve: {time.perf_counter() - t0:.1f}s")

    # Scan-length slope timing: time k-step and 3k-step scans and report the
    # slope, which excludes the per-dispatch latency a single scan would
    # fold in; the np.asarray host fetch forces the whole scan to finish.
    import numpy as np

    def scan_rate(stepper, state, steps, n_markers, tag="", reps=3):
        """Pushes/s by the two-point scan-slope method, repeated `reps`
        times back to back (the spread across repetitions separates kernel
        regressions from host noise).  Returns (best rate, all rates, state
        after one 3k-step scan)."""
        multi_a = stepper.make_multi_step(steps)
        multi_b = stepper.make_multi_step(3 * steps)
        t0 = time.perf_counter()
        np.asarray(multi_a(state).electric)
        log(f"first {steps}-step scan{tag} (compile+run): "
            f"{time.perf_counter() - t0:.1f}s")
        np.asarray(multi_b(state).electric)

        # Robust per-side minima: host latency noise is strictly additive,
        # so min(t_b) - min(t_a) converges to the true slope, while the
        # paired min_i(t_b_i - t_a_i) deflates whenever one t_a sample
        # catches a hiccup (the glitchy pair wins the min).
        rates = []
        for _ in range(reps):
            tas, tbs = [], []
            for _ in range(4):
                t0 = time.perf_counter()
                np.asarray(multi_a(state).electric)
                tas.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                sb = multi_b(state)
                np.asarray(sb.electric)
                tbs.append(time.perf_counter() - t0)
            # /(2*steps) per step x steps back = /2 total; one hiccup on
            # the warm side must not yield a negative/inf headline
            elapsed = (min(tbs) - min(tas)) / 2
            if elapsed <= 0:
                raise RuntimeError(
                    f"non-positive scan slope ({min(tbs):.3f}s vs "
                    f"{min(tas):.3f}s): host noise exceeded the 2k-step "
                    "difference; re-run on an idle host or raise "
                    "PIC1DP_BENCH_STEPS")
            # 2 RK substeps per step, each pushing every marker
            rates.append(2.0 * n_markers * steps / elapsed)
        # additive noise only deflates a repetition's rate -> best-of-reps
        # is the minimal-noise estimate (consistent with the per-side-min
        # slope); the full list is reported for the spread fields
        rate = max(rates)
        log(f"slope of {steps}- vs {3 * steps}-step scans{tag} -> "
            + " / ".join(f"{r:.3e}" for r in rates)
            + f" pushes/s (best {2.0 * n_markers * steps / rate * 1e3:.2f}"
            f" ms/step)")
        return rate, rates, sb

    rate, rates, state = scan_rate(stepper, state, steps, n)

    # Inputs for the secondary metrics, extracted NOW so the big headline
    # SimState can be freed before the 1e8-marker row allocates its own
    # (the headline state on top of the 1e8 row would roughly double peak
    # device memory).
    xs, vals = jnp.array(state.x[0]), jnp.array(state.w[0])
    grid0 = jnp.asarray(state.electric)
    rho0 = jnp.asarray(state.rho)
    # wtimer-parity per-phase decomposition (reference
    # src/pic1dp_output.F90:576-627), PIC1DP_BENCH_PHASES=1 (needs the
    # headline state, so it runs before the 1e8 row frees it)
    if int(os.environ.get("PIC1DP_BENCH_PHASES", "0")):
        from pic1dp_tpu.utils.phase_split import (format_phase_table,
                                                  measure_phase_split)

        log(format_phase_table(measure_phase_split(stepper, state, steps)))
    del state

    # The literal BASELINE.json config-4 size (1e8 markers, 1024 cells) as a
    # first-class row: same config at n=1e8, measured the same way.  PIC1DP_BENCH_1E8=0 skips it; it is skipped
    # automatically when the headline n already is 1e8.
    rate_1e8 = n_1e8 = None
    if (int(os.environ.get("PIC1DP_BENCH_1E8", "1"))
            and dev.platform != "cpu"):
        n_1e8 = 100_000_000
        if n_1e8 != n:
            cfg8 = dataclasses.replace(cfg, nparticle_max=n_1e8).validate()
            stepper8 = Stepper(cfg8)
            t0 = time.perf_counter()
            state8 = load_particles(cfg8, jax.random.PRNGKey(12345))
            state8 = stepper8.initial_field(state8)
            jax.block_until_ready(state8.electric)
            log(f"[1e8] load+initial solve: {time.perf_counter() - t0:.1f}s")
            rate_1e8, _, _ = scan_rate(stepper8, state8, steps, n_1e8,
                                       tag=" [1e8]", reps=1)
            del state8
        else:
            rate_1e8 = rate

    # secondary: deposition SpMV nnz/s MEASURED from the EXPLICIT-path pair
    # (S^T val segment-sum deposit and the two-level one-hot gather S E,
    # 2 nnz per marker — ops/shape_matrix.py; reference strategies 1-3,
    # src/pic1dp_interaction.F90:46-78, :213-220), and the Poisson solve in
    # the reference's semantics — rho(x) -> kept modes -> E(x) via the
    # partial-DFT matmul pair (src/pic1dp_field.F90:218-257).  All timed by
    # the two-point scan-slope method so the dispatch latency cancels.
    payload = {
        "metric": "particles_pushed_per_sec_per_chip",
        "device": device,
        "value": rate,
        "unit": "pushes/s",
        "vs_baseline": rate / PINNED_BASELINE,
        "vs_baseline_live": rate / baseline,
        # same-session repetition spread (min(t_b)-min(t_a) slope per rep,
        # value = best rep): tells kernel regressions from host noise
        "spread_rates": [round(r, -6) for r in sorted(rates)],
        "spread_rel": (max(rates) - min(rates)) / max(rates),
    }
    if rate_1e8 is not None:
        payload["value_1e8_markers"] = rate_1e8
        payload["n_1e8_markers"] = n_1e8

    if not int(os.environ.get("PIC1DP_BENCH_SECONDARY", "1")):
        print(json.dumps(payload))
        return

    from pic1dp_tpu.ops.shape_matrix import ShapeMatrix

    sm0 = jax.jit(lambda x: ShapeMatrix.assemble(x, cfg.lx, cfg.nx))(xs)
    gmethod = "take"  # measured fastest on the H100 and the CPU (PERF.md)

    def spmv_slope(build, args, k):
        fa, fb = build(k), build(3 * k)
        np.asarray(fa(*args))
        np.asarray(fb(*args))
        tas, tbs = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            np.asarray(fa(*args))
            tas.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            np.asarray(fb(*args))
            tbs.append(time.perf_counter() - t0)
        return max((min(tbs) - min(tas)) / (2 * k), 1e-30)

    def deposit_loop(iters, method):
        @jax.jit
        def run(ix0, ix1, w0, w1, val):
            sm = ShapeMatrix(ix0, ix1, w0, w1, cfg.nx)

            def body(c, _):
                g = sm.deposit(val + c, method=method,
                               chunk=cfg.deposit_chunk)
                return 1e-30 * jnp.sum(g), None
            out, _ = jax.lax.scan(body, jnp.zeros((), val.dtype), None,
                                  length=iters)
            return out
        return run

    def gather_loop(iters):
        @jax.jit
        def run(ix0, ix1, w0, w1, grid):
            sm = ShapeMatrix(ix0, ix1, w0, w1, cfg.nx)

            def body(c, _):
                e_p = sm.gather(grid + c, method=gmethod,
                                chunk=cfg.deposit_chunk)
                return 1e-30 * jnp.sum(e_p), None
            out, _ = jax.lax.scan(body, jnp.zeros((), grid.dtype), None,
                                  length=iters)
            return out
        return run

    k_spmv = int(os.environ.get("PIC1DP_BENCH_SPMV_ITERS", 2))
    coo = (sm0.ix0, sm0.ix1, sm0.w0, sm0.w1)
    # time BOTH S^T methods and report the per-nx winner (the production
    # EXPLICIT path selects by nx, core/step.py _auto_method)
    dep_by_method = {
        m: spmv_slope(lambda it, m=m: deposit_loop(it, m), coo + (vals,),
                      k_spmv)
        for m in ("onehot", "segment")}
    dmethod, dep_s = min(dep_by_method.items(), key=lambda kv: kv[1])
    gat_s = spmv_slope(gather_loop, coo + (grid0,), k_spmv)
    nnz = 2.0 * xs.size
    log(f"EXPLICIT-path SpMV (measured, nx={nx}): deposit S^T w "
        f"({dmethod}) {nnz / dep_s:.3e} nnz/s ({dep_s * 1e3:.1f} ms; "
        + ", ".join(f"{m} {nnz / s:.2e}" for m, s in dep_by_method.items())
        + f"), gather S E ({gmethod}) {nnz / gat_s:.3e} nnz/s "
        f"({gat_s * 1e3:.1f} ms)")
    payload["deposit_nnz_per_sec"] = nnz / dep_s
    payload["deposit_method"] = dmethod
    payload["gather_nnz_per_sec"] = nnz / gat_s

    from pic1dp_tpu.ops.spectral import SpectralOperator

    op = SpectralOperator.create(nx, cfg.modes, cfg.lx, xs.dtype)

    def poisson_loop(iters):
        @jax.jit
        def run(rho):
            def body(carry, _):
                e, mre, _ = op.solve(rho + carry)
                # jnp.sum serializes iterations AND consumes every element
                # (an element pick would let XLA slice through the matmuls)
                return 1e-30 * (jnp.sum(e) + mre[0]), None
            out, _ = jax.lax.scan(
                body, jnp.zeros((), rho.dtype), None, length=iters)
            return out
        return run

    # two-point slope (4k vs 12k iterations): subtracts the scan dispatch
    # overhead that a single-loop timing folds in.  The solve takes
    # microseconds, so the iteration counts must be large enough for the
    # 8k-iteration difference to clear host noise.
    la, lb = poisson_loop(4096), poisson_loop(12288)
    np.asarray(la(rho0))
    np.asarray(lb(rho0))
    tas, tbs = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        np.asarray(la(rho0))
        tas.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        np.asarray(lb(rho0))
        tbs.append(time.perf_counter() - t0)
    solve_us = max((min(tbs) - min(tas)) / 8192 * 1e6, 0.0)
    log(f"Poisson solve (rho->modes->E, nx={nx}, nmode={len(cfg.modes)}): "
        f"{solve_us:.1f} us/solve")
    log(f"field energy sanity: {float(jnp.sum(grid0**2)):.3e}")

    print(json.dumps(payload))


if __name__ == "__main__":
    main()
