"""Smoke test of pic1dp on one NVIDIA GPU, through the entry points a user
calls, at the reference's own sizes.

    python chip_smoke.py              # phases (a)-(d) on one GPU
    python chip_smoke.py --cards 4    # phase (e) only: 4-GPU sharded step

Phases, all in this one process (only `nvidia-smi` runs as a child):

  (a) device: a GPU must be JAX's first device; print the card's name and
      power limit as nvidia-smi reports them.
  (b) main path: the PRE 83 bump-on-tail run (nx=192, 6.4e6 markers, dt
      0.05 to t=500, output every 0.5) through `python -m pic1dp_tpu.run`'s
      main with the PETSc-binary writer on; the output file is read back
      and the linear growth rate fitted from the mode series must lie
      within 2% of the kinetic dispersion root.
  (c) kernels against references: one step of the fused substep kernels
      against the XLA step at 2^26 markers, nx=1024 (nmode 1 and 4, and
      two species); the spectral solve at nx=4096 against a float64 NumPy
      solve.
  (d) capacity: the nonlinear delta-f scan compiled at 1e8 markers,
      nx=1024; its memory analysis and the peak device memory after a few
      steps.
  (e) four cards: ShardedStepper over 4 GPUs against one GPU, same seed.

Any failure raises and exits non-zero.  The last line of standard output
is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time

import numpy as np

PRE83_GAMMA_TOL = 0.02
# float32 one-step agreement of the fused kernels with the XLA step.  Both
# evaluate the same arithmetic in a different order (FMA contraction,
# polynomial vs libdevice trig at ~1 ulp), so particle coordinates agree to
# a few ulp of their own scale; the mode amplitudes are sums over 2^26
# markers taken in a different order (per-block partial sums vs XLA's
# reduction tree), whose rounding is bounded by ~log2(N) ulp of the sum of
# absolute terms — which for a noise-level delta-f signal is far above the
# ulp of the sum itself.
STEP_TOL = {"x": 2e-6, "v": 2e-6, "w": 2e-5, "mode": 1e-3}
SOLVE_TOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def phase_device():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU found (JAX's first device is "
                         f"{dev.platform}:{dev.device_kind})")
    log(f"(a) device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    log(f"(a) nvidia-smi: {gpu_name_and_power()}")
    return dev


def phase_main_path(out_dir: str, overrides=(), window=(25.0, 70.0),
                    tol: float | None = PRE83_GAMMA_TOL) -> dict:
    """The PRE 83 run through pic1dp_tpu.run.main with the writer on; the
    growth rate is fitted from the written mode series, as bench/physics.py
    does for this case."""
    from pic1dp_tpu import run
    from pic1dp_tpu.analysis.dispersion import (Dispersion, fit_mode_omega,
                                                species_for_config)
    from pic1dp_tpu.analysis.output_data import OutputData
    from pic1dp_tpu.config import bump_on_tail_default

    argv = ["-o", out_dir, "-s", "verbosity=0"]
    for item in overrides:
        argv += ["-s", item]
    t0 = time.perf_counter()
    rc = run.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"pic1dp_tpu.run.main returned {rc}")
    cfg = run._apply_overrides(bump_on_tail_default(), list(overrides))
    od = OutputData(out_dir)
    t = od.get_scalar_t()[0]
    modes = od.get_mode_t()
    expected = int(round(cfg.time_max / cfg.output_interval)) + 1
    if od.ntime != expected:
        raise RuntimeError(f"output holds {od.ntime} snapshots, "
                           f"expected {expected}")
    if not (np.all(np.isfinite(modes)) and np.all(np.isfinite(t))):
        raise RuntimeError("non-finite values in the written output")
    k = 2.0 * math.pi / cfg.lx
    om = Dispersion(species_for_config(cfg), k).solve_omega()
    fit = fit_mode_omega(t, modes[0], modes[cfg.nmode], window=window)
    rel = abs(fit.imag - om.imag) / abs(om.imag)
    log(f"(b) PRE 83 run: {cfg.nparticle_max} markers, nx={cfg.nx}, "
        f"{od.ntime} snapshots, {wall:.1f}s wall incl. compile; "
        f"gamma {fit.imag:.6f} vs kinetic root {om.imag:.6f} "
        f"({rel:.3%}); omega_r {fit.real:.5f} vs {abs(om.real):.5f}")
    if tol is not None and not rel <= tol:
        raise RuntimeError(f"PRE 83 gamma off by {rel:.3%} (> {tol:.0%})")
    return {"gamma": fit.imag, "gamma_theory": om.imag, "rel_err": rel,
            "snapshots": od.ntime, "wall_s": wall}


def _step_cases(n: int, nx: int):
    """(name, config) pairs of phase (c), all at nx: nmode 1 and 4
    bump-on-tail, and the two-species ion-acoustic physics
    (examples/ion_acoustic.py; n markers in total)."""
    import dataclasses

    from pic1dp_tpu.config import (Equilibrium, MarkerLoading,
                                   SpeciesConfig, bump_on_tail_default)

    base = bump_on_tail_default(nx=nx, nparticle_max=n, dtype="float32",
                                verbosity=0)
    yield "nmode1", base
    yield "nmode4", dataclasses.replace(base, modes=(1, 2, 3, 4))
    yield "two_species", dataclasses.replace(
        base, lx=4.0 * math.pi, equilibrium=Equilibrium.MAXWELLIAN,
        species=(SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.0,
                               density=1.0, v0=0.0),
                 SpeciesConfig(charge=1.0, mass=25.0, temperature=0.05,
                               density=1.0, v0=0.0)),
        nparticle_max=n // 2, marker=MarkerLoading.PHYSICAL,
        init_amp_sin=(3e-4,)).validate()


def _rel(a, b, period=None) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d = np.abs(a - b)
    if period is not None:
        d = np.minimum(d, period - d)
    return float(np.max(d) / (np.max(np.abs(a)) + 1e-300))


def phase_kernels(n: int = 2**26, nx: int = 1024, solve_nx: int = 4096,
                  interpret: bool = False) -> dict:
    """One step of the fused kernels against the XLA step, and the spectral
    solve against float64 NumPy."""
    import dataclasses

    import jax

    from pic1dp_tpu.config import DepositMethod
    from pic1dp_tpu.core.loading import load_particles
    from pic1dp_tpu.core.step import Stepper
    from pic1dp_tpu.ops.spectral import SpectralOperator

    out = {}
    for name, cfg in _step_cases(n, nx):
        # for the matrix-free shape every method but PALLAS runs the XLA step
        ref = Stepper(dataclasses.replace(
            cfg, deposit_method=DepositMethod.SEGMENT))
        fused = Stepper(dataclasses.replace(
            cfg, deposit_method=DepositMethod.PALLAS), interpret=interpret)
        state = ref.initial_field(load_particles(cfg, jax.random.PRNGKey(7)))
        a = jax.device_get(ref.step(state))
        b = jax.device_get(fused.step(state))
        del state
        errs = {"x": _rel(a.x, b.x, period=cfg.lx), "v": _rel(a.v, b.v),
                "w": _rel(a.w, b.w),
                "mode": max(_rel(np.hypot(a.mode_re, a.mode_im),
                                 np.hypot(b.mode_re, b.mode_im)),
                            _rel(a.mode_re, b.mode_re),
                            _rel(a.mode_im, b.mode_im))}
        log(f"(c) kernel vs XLA step, {name} ({cfg.nspecies} x "
            f"{cfg.nparticle_max} markers, nx={cfg.nx}, modes={cfg.modes}): "
            + ", ".join(f"{k} {v:.2e} (tol {STEP_TOL[k]:.0e})"
                        for k, v in errs.items()))
        for k, v in errs.items():
            if not (np.isfinite(v) and v <= STEP_TOL[k]):
                raise RuntimeError(f"kernel step {name}: {k} off by {v:.2e}")
        out[name] = errs
    # the spectral solve: HIGHEST-precision matmuls against float64 NumPy
    modes = (1, 2, 3, 4)
    op = SpectralOperator.create(solve_nx, modes, 2.0 * math.pi / 0.36,
                                 np.float32)
    rng = np.random.default_rng(0)
    rho = rng.standard_normal(solve_nx).astype(np.float32)
    e, mre, mim = jax.device_get(jax.jit(op.solve)(rho))
    fre = np.asarray(op.fre, np.float64)
    fim = np.asarray(op.fim, np.float64)
    gi = np.asarray(op.grad_inv, np.float64)
    r64 = rho.astype(np.float64)
    mre64 = fim.T @ r64 / solve_nx * gi
    mim64 = -(fre.T @ r64) / solve_nx * gi
    e64 = 2.0 * (fre @ mre64 + fim @ mim64)
    err = max(_rel(mre64, mre), _rel(mim64, mim), _rel(e64, e))
    log(f"(c) spectral solve nx={solve_nx}, modes={modes}: max rel err "
        f"{err:.2e} vs float64 (tol {SOLVE_TOL:.0e})")
    if not err <= SOLVE_TOL:
        raise RuntimeError(f"spectral solve off by {err:.2e}")
    out["solve"] = err
    return out


def phase_capacity(n: int = 100_000_000, nx: int = 1024,
                   steps: int = 3) -> dict:
    """Compile the nonlinear delta-f scan at n markers and run it."""
    import jax

    from pic1dp_tpu.config import bump_on_tail_default
    from pic1dp_tpu.core.loading import load_particles
    from pic1dp_tpu.core.step import Stepper

    cfg = bump_on_tail_default(nx=nx, nparticle_max=n, dtype="float32",
                               verbosity=0)
    st = Stepper(cfg)
    state = st.initial_field(load_particles(cfg, jax.random.PRNGKey(3)))
    t0 = time.perf_counter()
    compiled = st.make_multi_step(steps).lower(state).compile()
    log(f"(d) {steps}-step scan at {n} markers, nx={nx}: compiled in "
        f"{time.perf_counter() - t0:.1f}s; memory_analysis: "
        f"{compiled.memory_analysis()}")
    state = compiled(state)
    jax.block_until_ready(state)
    if not np.all(np.isfinite(np.asarray(state.mode_re))):
        raise RuntimeError("non-finite modes after the capacity steps")
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    log(f"(d) peak_bytes_in_use after {steps} steps: {peak} "
        f"({(peak or 0) / n:.1f} B/marker)")
    return {"peak_bytes_in_use": peak}


def phase_cards(ncards: int = 4, n: int = 2**26, nx: int = 1024,
                steps: int = 5) -> dict:
    """ShardedStepper over ncards devices against one device, same seed.
    The mode amplitudes may differ only by summation order: per-device
    partial sums plus a psum instead of one reduction."""
    import jax

    from pic1dp_tpu.config import bump_on_tail_default
    from pic1dp_tpu.core.loading import load_particles
    from pic1dp_tpu.core.step import Stepper
    from pic1dp_tpu.parallel import mesh as pmesh

    if len(jax.devices()) < ncards:
        raise RuntimeError(f"{ncards} devices needed, "
                           f"{len(jax.devices())} found")
    cfg = bump_on_tail_default(nx=nx, nparticle_max=n, dtype="float32",
                               verbosity=0)
    mesh = pmesh.make_mesh(ncards)
    sharded = pmesh.ShardedStepper(cfg, mesh)
    single = Stepper(cfg)
    state = load_particles(cfg, jax.random.PRNGKey(11))
    a = single.initial_field(state)
    b = sharded.initial_field(pmesh.shard_state(state, mesh))
    del state
    t0 = time.perf_counter()
    a = single.make_multi_step(steps)(a)
    b = sharded.make_multi_step(steps)(b)
    jax.block_until_ready((a, b))
    amp_a = np.hypot(np.asarray(a.mode_re), np.asarray(a.mode_im))
    amp_b = np.hypot(np.asarray(b.mode_re), np.asarray(b.mode_im))
    err = _rel(amp_a, amp_b)
    log(f"(e) {steps} steps on {ncards} cards vs 1 card ({n} markers, "
        f"nx={nx}): mode amplitude rel diff {err:.2e} "
        f"(tol {STEP_TOL['mode']:.0e}); {time.perf_counter() - t0:.1f}s")
    if not err <= STEP_TOL["mode"]:
        raise RuntimeError(f"sharded modes off by {err:.2e}")
    return {"mode_rel_diff": err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="with 4: run only the 4-GPU sharded phase (e)")
    args = ap.parse_args(argv)

    import jax

    from pic1dp_tpu.utils.compile_cache import enable_compilation_cache

    dev = phase_device()
    enable_compilation_cache()
    if args.cards > 1:
        phase_cards(args.cards)
    else:
        with tempfile.TemporaryDirectory() as out_dir:
            phase_main_path(out_dir)
        # before (c): peak_bytes_in_use is the process's peak so far, and
        # (c)'s XLA steps at 2^26 need more than the 1e8 kernel scan
        phase_capacity()
        phase_kernels()
    log(f"nvidia-smi: {gpu_name_and_power()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
