"""Seeded run-to-run spread artifact.

The reference's quantitative pipeline includes group statistics over seeded
runs — mean/std of gamma, saturation level/time, int E^2 dt over a group
(reference tools/runinfo.py:137-230: the `-g` group machinery).  This script
exercises that exact ported path on REAL multi-run data:

  1. run the PRE 83, 056402 bump-on-tail headline case NSEEDS times with
     different RNG seeds, writing each run's pic1dp.out via the production
     writer;
  2. feed the run directories to analysis.runinfo.main() with
     `-g NSEEDS -gr 25 70 -sr 70 500 -wg group.dat` — the group mean/std in
     the artifact come out of runinfo's own accumulation, not a re-
     implementation;
  3. per-run, also record the two-pole mode fit (fit_mode_omega) next to the
     runinfo energy fit, and int E^2 dt via runinfo.intfdt;
  4. assert gamma_theory lies within the seed spread (mean +- 2 std of the
     mode fit) and report how many seed-sigmas it sits from the mean.

This is what makes single-run saturation numbers meaningful: the mean/std
bounds the run-to-run scatter.

Usage: python bench/spread.py --out spread.json [--cpu] [--nseeds 8]
Env: PIC1DP_SPREAD_N (markers/run), PIC1DP_SPREAD_TMAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--nseeds", type=int, default=8)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    backend = jax.devices()[0].platform
    on_cpu = backend == "cpu"
    if on_cpu:
        jax.config.update("jax_enable_x64", True)
    else:
        from pic1dp_tpu.utils.compile_cache import enable_compilation_cache

        enable_compilation_cache()

    import dataclasses

    import numpy as np

    from pic1dp_tpu import Simulation
    from pic1dp_tpu.analysis import runinfo
    from pic1dp_tpu.analysis.dispersion import (Dispersion, fit_mode_omega,
                                                species_for_config)
    from pic1dp_tpu.analysis.output_data import OutputData
    from pic1dp_tpu.config import bump_on_tail_default

    n = int(float(os.environ.get(
        "PIC1DP_SPREAD_N", 1_000_000 if on_cpu else 6_400_000)))
    t_end = float(os.environ.get(
        "PIC1DP_SPREAD_TMAX", 100.0 if on_cpu else 500.0))
    dtype = "float64" if on_cpu else "float32"
    gr = (25.0, 70.0)
    sr = (70.0, t_end) if t_end > 150.0 else (0.6 * t_end, t_end)

    cfg0 = bump_on_tail_default(nparticle_max=n, time_max=t_end,
                                output_interval=1.0, dtype=dtype,
                                verbosity=0)
    k = 2.0 * np.pi / cfg0.lx
    om = Dispersion(species_for_config(cfg0), k).solve_omega()
    log(f"theory: k = {k:.4f}, omega = {om:.6g}; {args.nseeds} seeds, "
        f"n = {n}, t_end = {t_end}, backend = {backend}")

    per_run = []
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for seed in range(args.nseeds):
            cfg = dataclasses.replace(
                cfg0, rng=dataclasses.replace(cfg0.rng, seed=seed))
            path = os.path.join(tmp, f"seed{seed}")
            os.makedirs(path)
            t0 = time.perf_counter()
            Simulation(cfg, out_path=path).run()
            wall = time.perf_counter() - t0
            od = OutputData(path)
            sc = od.get_scalar_t()
            mt = od.get_mode_t()
            tv, eng = sc[0], sc[1]
            om_fit = fit_mode_omega(tv, mt[0], mt[od.nmode], window=gr)
            pk = od.findpeak_energy(*sr)
            row = {
                "seed": seed,
                "gamma_mode_fit": om_fit.imag,
                "omega_mode_fit": om_fit.real,
                "gamma_energy_fit": od.growthrate_energy_fit(*gr) / 2.0,
                "saturation_time": pk[0],
                "saturation_level": pk[1],
                "int_e2_dt": runinfo.intfdt(tv, eng),
                "wall_s": round(wall, 2),
            }
            per_run.append(row)
            log(json.dumps(row))
            paths.append(path)

        # exercise the ported group machinery itself (-g/-wg path)
        gdat = os.path.join(tmp, "group.dat")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            runinfo.main(["-g", str(args.nseeds), "-gr", str(gr[0]),
                          str(gr[1]), "-sr", str(sr[0]), str(sr[1]),
                          "-wg", gdat] + paths)
        runinfo_stdout = buf.getvalue()
        with open(gdat) as fh:
            keys = fh.readline().lstrip("# ").split()
            vals = [float(x) for x in fh.readline().split()]
        group = dict(zip(keys, vals))

    gm = np.array([r["gamma_mode_fit"] for r in per_run])
    mean, std = float(np.mean(gm)), float(np.std(gm))
    nsigma = abs(mean - om.imag) / std if std > 0 else float("inf")
    within = bool(abs(mean - om.imag) <= 2.0 * std)
    # the seed min/max range is the robust "within the spread" criterion:
    # the mode fit carries a small systematic floor (~0.45% delta-f
    # discreteness, docs/performance.md) that 2 std of a tight seed set can
    # undercut without anything being wrong
    in_range = bool(float(np.min(gm)) <= om.imag <= float(np.max(gm)))

    artifact = {
        "case": "bump_on_tail_pre83_seed_spread",
        "backend": backend, "dtype": dtype, "n_markers": n,
        "t_end": t_end, "nseeds": args.nseeds,
        "gamma_theory": om.imag, "omega_theory": abs(om.real),
        "fit_windows": {"growth": gr, "saturation": sr},
        "per_run": per_run,
        "runinfo_group_stats": group,
        "runinfo_group_source": "analysis.runinfo.main -g/-wg on the run "
                                "dirs (reference tools/runinfo.py:137-230)",
        "gamma_mode_fit_mean": mean,
        "gamma_mode_fit_std": std,
        "gamma_theory_nsigma_from_mean": nsigma,
        "gamma_theory_within_2std": within,
        "gamma_theory_within_seed_range": in_range,
        "saturation_anchor": (
            "spread-anchored only: gamma/omega are compared against kinetic-"
            "dispersion theory above, but the saturation level/time have NO "
            "external anchor — the PRE 83, 056402 sec V.A.2 published "
            "saturation figure is not in the retrieved material and this "
            "environment cannot fetch it, so the mean/std here establish "
            "seed-to-seed reproducibility, not agreement with the published "
            "value (see BASELINE.md)"),
        "runinfo_stdout_tail": runinfo_stdout.splitlines()[-12:],
    }
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(artifact, fh, indent=1)
        log(f"wrote {args.out}")
    print(json.dumps({
        "metric": "seed_spread_gamma",
        "mean": mean, "std": std, "theory": om.imag,
        "nsigma": nsigma, "within_2std": within, "within_range": in_range,
        "sat_level_mean": group.get("sat_mean"),
        "sat_level_std": group.get("sat_std"),
    }))
    return 0 if (within or in_range) else 1


if __name__ == "__main__":
    sys.exit(main())
