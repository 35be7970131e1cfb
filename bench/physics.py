"""Physics-accuracy benchmark: regenerable growth-rate + saturation artifact.

Runs the BASELINE.md verification cases — linear Landau damping, the PRE 83,
056402 bump-on-tail headline case (full t=500 nonlinear run), the nonlinear
two-stream instability, and multi-mode (nmode=4) two-stream runs — on
whatever backend is active, and measures everything the reference's
quantitative pipeline measures:

  * growth/damping rate: gamma = energy-fit/2 exactly as tools/runinfo.py
    :114-122, vs the kinetic dispersion root (tools/dispersion.py:130-157);
  * saturation level & time: peak int E^2 dx after the linear phase, the
    findpeak_energy metric (reference tools/OutputData.py:172-180,
    tools/runinfo.py:127-134);
  * per-mode growth at nmode > 1: |E_m|(t) fit from get_mode_t per kept
    mode vs the dispersion root at k_m = 2 pi m / lx
    (reference src/pic1dp_field.F90:230-257 solves every kept mode);
  * delta-f mode structure: phase/amplitude-free correlation of the
    simulated delta f(x, v) snapshot against the analytic eigenmode
    (analysis.dispersion.structure_correlation; reference mode-structure
    plot tools/dispersion.py:159-206 turned into a metric).

Emits one JSON line per measurement and, with --out FILE, the combined list
as one JSON artifact — regenerable with one command.

On a GPU the bump-on-tail and two-stream cases also run with
bf16_weights=True to pin that mode's gamma error budget on the card.

Usage:
    python bench/physics.py [--out PHYSICS.json] [--cpu] [--no-bf16]
                            [--skip-multimode] [--quick]
Env: PIC1DP_PHYSICS_N_BOT / _N_TS / _N_LANDAU / _N_MM override marker counts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _fit_gamma(t, e, window, peaks_only=False):
    import numpy as np

    lo, hi = window
    if peaks_only:
        idx = [i for i in range(1, len(e) - 1)
               if e[i] > e[i - 1] and e[i] > e[i + 1] and lo <= t[i] <= hi]
    else:
        idx = [i for i in range(len(e)) if lo <= t[i] <= hi and e[i] > 0]
    return float(np.polyfit(t[idx], np.log(e[idx]), 1)[0] / 2.0)


def _log_slope(tv, amp):
    """LS slope of ln(amp) over tv, guarded: a zero/denormal amplitude
    sample would send np.log to -inf and silently poison np.polyfit into a
    nan gamma row, and a window catching < 4 samples is a config error —
    both fail loudly here instead."""
    import numpy as np

    tv, amp = np.asarray(tv), np.asarray(amp)
    if tv.size < 4:
        raise ValueError(f"log-slope window has only {tv.size} samples")
    if not np.all(amp > 1e-300):
        raise ValueError("log-slope window contains non-positive/denormal "
                         f"amplitudes (min {amp.min():.3e})")
    return float(np.polyfit(tv, np.log(amp), 1)[0])


def _findpeak(t, e, window):
    """Saturation peak of int E^2 dx in [t1, t2] (reference
    tools/OutputData.py:172-180: the max and its time)."""
    import numpy as np

    lo, hi = window
    m = (t >= lo) & (t <= hi)
    i = int(np.argmax(e[m]))
    return float(t[m][i]), float(e[m][i])


_LAST_RUN = {}  # side-channel extras from the most recent _run_case


def _run_case(cfg, out_path=None, want_modes=False):
    import numpy as np

    from pic1dp_tpu import Simulation

    snaps = []
    t0 = time.perf_counter()
    Simulation(cfg, out_path=out_path).run(snapshot_callback=snaps.append)
    wall = time.perf_counter() - t0
    t = np.array([s["time"] for s in snaps])
    e = np.array([s["field_energy"] for s in snaps])
    # total kinetic energy summed over species per snapshot (diagnostics
    # "total" row; the full-f conservation check reads this)
    _LAST_RUN["kinetic_total"] = np.array(
        [float(np.sum(s["total"])) for s in snaps])
    if want_modes:
        zre = np.stack([s["mode_re"] for s in snaps], axis=1)
        zim = np.stack([s["mode_im"] for s in snaps], axis=1)
        return t, e, wall, (zre, zim)
    return t, e, wall


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=str, default=None,
                    help="write the combined JSON artifact here")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--no-bf16", action="store_true",
                    help="skip the bf16_weights error-budget variants")
    ap.add_argument("--skip-multimode", action="store_true",
                    help="skip the nmode=4 cases")
    ap.add_argument("--quick", action="store_true",
                    help="shorten the PRE83 run to t=100 (no saturation row)")
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

    from pic1dp_tpu.analysis.dispersion import (Dispersion, fit_mode_omega,
                                                species_for_config,
                                                structure_correlation)
    from pic1dp_tpu.analysis.output_data import OutputData
    from pic1dp_tpu.config import (bump_on_tail_default, landau_damping,
                                   two_stream)

    dtype = "float64" if on_cpu else "float32"
    log(f"backend: {backend}  dtype: {dtype}")
    results = []

    def emit(row):
        results.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            # incremental write: a crash mid-suite (e.g. a diverging case)
            # must not lose the completed rows' chip time
            with open(args.out, "w") as fh:
                json.dump(results, fh, indent=1)
        return row

    def record(case, cfg, gamma_theory, window, peaks_only=False,
               sat_window=None, out_path=None, mode_window=None,
               omega_theory=None, mode_fit="omega"):
        """One growth-rate row.  With mode_window, gamma_sim comes from the
        kept-mode series — mode_fit="omega": the two-pole TLS fit
        (fit_mode_omega), exact for PROPAGATING modes whose standing-wave
        beat biases any log-slope; mode_fit="slope": the log|amp| LS slope,
        the robust estimator for purely GROWING modes (omega_r = 0), whose
        series carry non-pole components (ballistic residue, sampling
        shadow) that break Prony-type fits (measured 6-100% errors) while
        the slope over the exponential-dominant window matches theory to
        <1%.  The energy fit is kept as the runinfo.py-parity column;
        without mode_window, gamma_sim IS the energy fit (reference
        tools/runinfo.py:114-122 semantics)."""
        t, e, wall, (zre, zim) = _run_case(cfg, out_path=out_path,
                                           want_modes=True)
        gamma_energy = _fit_gamma(t, e, window, peaks_only)
        row = {"case": case, "gamma_theory": gamma_theory,
               "dtype": cfg.dtype, "bf16_weights": cfg.bf16_weights,
               "backend": backend, "n_markers": cfg.nparticle_max,
               "wall_s": round(wall, 2)}
        if mode_window is not None and mode_fit == "slope":
            sel = (t >= mode_window[0]) & (t <= mode_window[1])
            amp = np.hypot(zre[0], zim[0])
            row["gamma_sim"] = _log_slope(t[sel], amp[sel])
            row["gamma_energy_runinfo_parity"] = gamma_energy
            row["fit"] = f"mode-amplitude log-slope, window {mode_window}"
        elif mode_window is not None:
            om_fit = fit_mode_omega(t, zre[0], zim[0], window=mode_window)
            row["gamma_sim"] = om_fit.imag
            row["gamma_energy_runinfo_parity"] = gamma_energy
            row["fit"] = f"fit_mode_omega window {mode_window}"
            if omega_theory is not None:
                row["omega_sim"] = om_fit.real
                row["omega_theory"] = abs(omega_theory)
                row["omega_rel_err"] = (abs(om_fit.real - abs(omega_theory))
                                        / abs(omega_theory))
        else:
            row["gamma_sim"] = gamma_energy
        row["rel_err"] = (abs(row["gamma_sim"] - gamma_theory)
                          / abs(gamma_theory))
        if sat_window is not None:
            st, sl = _findpeak(t, e, sat_window)
            row["saturation_time"] = st
            row["saturation_level"] = sl
        emit(row)
        return t, e

    def _ts_disp(k):
        d = Dispersion([s for s in species_for_config(
            two_stream(nparticle=2048, verbosity=0))], k)
        d._guesses = [0.01 + 0.3j, 0.02 + 0.5j, 0.05 + 0.4j]
        return d

    # --- case 1: linear Landau damping (BASELINE.md config 2) ------------
    # gamma AND omega_r from the kept-mode amplitude series via the
    # two-pole TLS fit (analysis.dispersion.fit_mode_omega) — the energy
    # peaks fit (runinfo.py parity) carries a transient + peak-jitter bias
    # of ~1.3% that does NOT shrink with marker count (bisected in
    # bench/landau_sweep.py); the mode fit reaches the measured ~0.45%
    # plateau
    # (N-independent from 2^22 to 2^24; insensitive to dt/2, nx x4,
    # v_max 8, amp/10 and the window — the delta-f discreteness floor).
    n_lan = int(float(os.environ.get(
        "PIC1DP_PHYSICS_N_LANDAU", 102_400 if on_cpu else 2**24)))
    cfg = landau_damping(nx=64, nparticle=n_lan, k=0.5, amp=1e-4,
                         time_max=20.0, output_interval=0.1, dtype=dtype,
                         verbosity=0, dt=0.025)
    om = Dispersion(species_for_config(cfg), 0.5).solve_omega()
    log(f"landau theory: omega = {om:.6g}")
    t, e, wall, (zre, zim) = _run_case(cfg, want_modes=True)
    window = (5.0, 15.0) if on_cpu else (8.0, 18.0)  # above the 102k
    # noise floor on CPU; past the 2nd-root/transient shadow on chip
    om_fit = fit_mode_omega(t, zre[0], zim[0], window=window)
    gamma_peaks = _fit_gamma(t, e, (1.0, 15.0), peaks_only=True)
    emit({"case": "landau_damping_k0.5",
          "gamma_sim": om_fit.imag, "gamma_theory": om.imag,
          "rel_err": abs(om_fit.imag - om.imag) / abs(om.imag),
          "omega_sim": om_fit.real, "omega_theory": abs(om.real),
          "omega_rel_err": abs(om_fit.real - abs(om.real)) / abs(om.real),
          "gamma_peaks_runinfo_parity": gamma_peaks,
          "fit": f"fit_mode_omega window {window}",
          "dtype": cfg.dtype, "bf16_weights": cfg.bf16_weights,
          "backend": backend, "n_markers": cfg.nparticle_max,
          "wall_s": round(wall, 2)})

    # --- case 2: PRE 83, 056402 bump-on-tail headline case ----------------
    # full t=500 nonlinear run (reference default, src/pic1dp_input.F90:35):
    # gamma over the linear phase + saturation level/time via findpeak
    n_bot = int(float(os.environ.get(
        "PIC1DP_PHYSICS_N_BOT", 6_400_000 if not on_cpu else 1_000_000)))
    t_end = 100.0 if (on_cpu or args.quick) else 500.0
    cfg = bump_on_tail_default(nparticle_max=n_bot, time_max=t_end,
                               output_interval=1.0, dtype=dtype, verbosity=0)
    k = 2.0 * np.pi / cfg.lx
    om = Dispersion(species_for_config(cfg), k).solve_omega()
    log(f"bump-on-tail theory: k = {k:.4f}, omega = {om:.6g}")
    window = (25.0, 70.0)
    sat_window = (70.0, t_end) if t_end > 150.0 else None
    record("bump_on_tail_pre83", cfg, om.imag, window, sat_window=sat_window,
           mode_window=window, omega_theory=om.real)
    if not (on_cpu or args.no_bf16):
        record("bump_on_tail_pre83_bf16", dataclasses.replace(
            cfg, bf16_weights=True), om.imag, window, sat_window=sat_window,
            mode_window=window, omega_theory=om.real)

    # --- case 3: nonlinear two-stream (BASELINE.md config 3) --------------
    # gamma + saturation + delta-f mode-structure correlation in the late
    # linear phase (t = 25, amplitude ~100x above noise, ~5x below sat).
    # 2^22 markers: a factor 4 over 1e6 costs seconds on the GPU and
    # halves the sampling floor
    n_ts = int(float(os.environ.get(
        "PIC1DP_PHYSICS_N_TS", 1_000_000 if on_cpu else 2**22)))
    cfg = two_stream(nparticle=n_ts, time_max=60.0, dtype=dtype,
                     output_interval=0.5, verbosity=0)
    disp = _ts_disp(0.2)
    om = disp.solve_omega()
    log(f"two-stream theory: omega = {om:.6g}")
    with tempfile.TemporaryDirectory() as tmp:
        # energy-fit window (15, 35) = runinfo parity; the mode-slope fit
        # stops at t = 28, before trapping saturation (~t = 30) bends the
        # exponential (a saturated tail in the window measured 79% off)
        record("two_stream_k0.2", cfg, om.imag, (15.0, 35.0),
               sat_window=(30.0, 60.0), out_path=tmp,
               mode_window=(15.0, 28.0), mode_fit="slope")
        od = OutputData(tmp)
        sc = od.get_scalar_t()
        it = int(np.argmin(np.abs(sc[0] - 25.0)))
        corr = structure_correlation(od, it, 1, disp)
        emit({"case": "two_stream_k0.2_mode_structure", "t_snapshot": 25.0,
              "structure_corr": corr, "n_markers": cfg.nparticle_max,
              "dtype": cfg.dtype, "bf16_weights": False, "backend": backend,
              "rel_err": 1.0 - corr})
    if not (on_cpu or args.no_bf16):
        record("two_stream_k0.2_bf16", dataclasses.replace(
            cfg, bf16_weights=True), om.imag, (15.0, 35.0),
            sat_window=(30.0, 60.0), mode_window=(15.0, 28.0),
            mode_fit="slope")

    # --- case 3a: TWO-SPECIES two-stream — the same instability loaded as
    # two counter-streaming Maxwellian SPECIES (nspecies=2, v0 = +-3,
    # density 0.5 each; reference nspecies surface,
    # src/pic1dp_input.F90:57-72) instead of the single-species two_stream2
    # composite.  Same dispersion root (identical equilibrium f0), so this
    # pins the MULTI-SPECIES fused kernels (one pallas_call per substep,
    # per-species selects) against the same oracle as case 3.
    from pic1dp_tpu.config import Equilibrium, SpeciesConfig

    sp2 = SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.0, density=0.5,
                        v0=3.0)
    cfg_2sp = dataclasses.replace(
        two_stream(nparticle=n_ts // 2, time_max=60.0, dtype=dtype,
                   output_interval=0.5, verbosity=0),
        equilibrium=Equilibrium.MAXWELLIAN,
        species=(sp2, dataclasses.replace(sp2, v0=-3.0))).validate()
    assert cfg_2sp.nspecies == 2
    d2 = Dispersion(species_for_config(cfg_2sp), 0.2)
    d2._guesses = [0.01 + 0.3j, 0.02 + 0.5j, 0.05 + 0.4j]
    om2 = d2.solve_omega()
    assert abs(om2 - om) < 1e-9  # same equilibrium -> same root
    record("two_stream_k0.2_two_species", cfg_2sp, om2.imag, (15.0, 35.0),
           sat_window=(30.0, 60.0), mode_window=(15.0, 28.0),
           mode_fit="slope")
    if not (on_cpu or args.no_bf16):
        # KNOWN LIMITATION (bisected, docs/performance.md): in
        # THIS configuration — two strongly shifted species whose uniform-
        # loaded far tails reach |v - v0| ~ 11 thermal widths, so the
        # delta-f weight equation's stiffness z = dt E (-f0'/f0) q/m is
        # ~2x the composite equilibrium's — the bf16 w1-stream rounding
        # destabilizes the saturated state (deterministic onset;
        # p-only quantization and all-f32 are stable).  The run is kept to
        # RECORD the boundary; a divergence emits an informational row
        # instead of killing the suite.
        try:
            record("two_stream_k0.2_two_species_bf16", dataclasses.replace(
                cfg_2sp, bf16_weights=True), om2.imag, (15.0, 35.0),
                sat_window=(30.0, 60.0), mode_window=(15.0, 28.0),
                mode_fit="slope")
        except FloatingPointError as ex:
            emit({"case": "two_stream_k0.2_two_species_bf16",
                  "informational": True, "diverged": True,
                  "note": ("bf16 w1-stream quantization destabilizes the "
                           "post-saturation state of this strongly-shifted "
                           "two-species configuration (stiff far-tail "
                           "-f0'/f0; bisected: p-only bf16 and f32 "
                           "both stable, onset deterministic) — use f32 or "
                           "a smaller dt for shifted multi-species bf16 "
                           "runs; see docs/performance.md"),
                  "error": str(ex), "dtype": dtype, "bf16_weights": True,
                  "backend": backend, "n_markers": cfg_2sp.nparticle_max})

    # --- case 3a2: ION-ACOUSTIC damping — electrons + HEAVY IONS ----------
    # Two species with genuinely different charge sign, mass, and
    # temperature (q/m = -1 vs +0.04): the only case that exercises the
    # fused kernels' per-species dtqm/charge scalar selects with DISTINCT
    # values on chip (the two-stream species pair shares q/m), and a
    # physically new regime: the slow quasineutral ion-acoustic wave
    # (omega ~ k*cs ~ 0.1 omega_pe) Landau-damped on BOTH species.
    # Parameters: m_i = 25, T_i/T_e = 0.05 -> root 0.09843 - 0.00774j at
    # k = 0.5 (Z-function, same oracle class).  PHYSICAL (per-species
    # Gaussian) marker loading — uniform-v loading would waste ions over
    # +-v_max = 178 ion-thermal widths.  Seed amplitude 3e-4 keeps ion
    # trapping negligible (omega_b/gamma ~ 0.09; larger seeds measurably
    # shallow the damping — REAL nonlinear trapping); the residual
    # percent-level gamma floor is resonant-ION sampling:
    # the resonance sits at v_res = omega/k = 4.4 vth_i, where only
    # ~1e-4 of the physically-loaded ion markers live (the reference's
    # global-v_max loading has the same limitation).
    if not on_cpu:  # ~6400 steps of a slow wave: minutes on chip only
        from pic1dp_tpu.config import Config, MarkerLoading

        k_ia = 0.5
        n_ia = int(float(os.environ.get("PIC1DP_PHYSICS_N_IA", 2**23)))
        cfg_ia = Config(
            linear=False, deltaf=True, lx=2.0 * np.pi / k_ia,
            equilibrium=Equilibrium.MAXWELLIAN,
            species=(SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.0,
                                   density=1.0, v0=0.0),
                     SpeciesConfig(charge=1.0, mass=25.0, temperature=0.05,
                                   density=1.0, v0=0.0)),
            nx=64, nparticle_max=n_ia, time_max=320.0, dt=0.05,
            marker=MarkerLoading.PHYSICAL, v_max=8.0,
            modes=(1,), init_modes=(1,), init_amp_cos=(0.0,),
            init_amp_sin=(3e-4,), output_interval=1.0, verbosity=0,
            dtype=dtype).validate()
        d_ia = Dispersion(species_for_config(cfg_ia), k_ia)
        d_ia._guesses = [0.098 - 0.008j, 0.118 - 0.010j, 0.078 - 0.006j]
        om_ia = d_ia.solve_omega()
        log(f"ion-acoustic theory: omega = {om_ia:.6g}")
        t, e, wall, (zre, zim) = _run_case(cfg_ia, want_modes=True)
        # window: past the Langmuir-branch ringdown (damped by t ~ 40 at
        # k lambda_De = 0.5), spanning ~2 ion-acoustic damping times
        ia_win = (60.0, 300.0)
        fit = fit_mode_omega(t, zre[0], zim[0], window=ia_win)
        vth_i = float(np.sqrt(0.05 / 25.0))
        v_res = abs(om_ia.real) / k_ia
        from math import erf

        res_frac = 0.5 * (erf((v_res + vth_i) / (np.sqrt(2) * vth_i))
                          - erf((v_res - vth_i) / (np.sqrt(2) * vth_i)))
        emit({"case": "ion_acoustic_k0.5_mi25",
              "gamma_sim": fit.imag, "gamma_theory": om_ia.imag,
              "rel_err": abs(fit.imag - om_ia.imag) / abs(om_ia.imag),
              "omega_sim": fit.real, "omega_theory": abs(om_ia.real),
              "omega_rel_err": abs(fit.real - abs(om_ia.real))
              / abs(om_ia.real),
              "fit": f"fit_mode_omega window {ia_win}",
              "gamma_floor_note": (
                  "earlier amplitude, dt, nx and marker scans of this case "
                  "converged to a percent-level residual: a small "
                  "discrete-system systematic, not statistics or "
                  "resolution; resonant ions sit at v_res = 4.4 vth_i "
                  f"(marker fraction near resonance {res_frac:.1e})"),
              "resonant_ion_marker_fraction": res_frac,
              "nspecies": 2, "marker": "physical", "dtype": dtype,
              "bf16_weights": False, "backend": backend,
              "n_markers": n_ia, "wall_s": round(wall, 2)})

    # --- case 3b: FULL-F two-stream (deltaf=False) + energy conservation --
    # The reference treats full-f as a first-class mode (input_ideltaf,
    # src/pic1dp_input.F90:104-106; full-f deposition branch
    # src/pic1dp_interaction.F90:57-70,142-148: deposit p, subtract the
    # equilibrium charge).  Full-f sampling noise is f0/sqrt(N) (not
    # delta f/sqrt(N)), so the mode starts on the marker-noise floor
    # ~ rho0/sqrt(N_cell); the two-stream instability at gamma = 0.28
    # grows through it in a few e-foldings — the fit window starts later
    # than the delta-f case.  Energy conservation (kinetic total + field)
    # closes the loop on the full-f diagnostic path: "total" kinetic energy
    # comes from sum p v^2 (diagnostics.energies), field from the solved E.
    n_ff = int(float(os.environ.get(
        "PIC1DP_PHYSICS_N_FF", 300_000 if on_cpu else 2**24)))
    cfg_ff = dataclasses.replace(
        two_stream(nparticle=n_ff, time_max=60.0, dtype=dtype,
                   output_interval=0.5, verbosity=0), deltaf=False)
    t, e, wall, (zre, zim) = _run_case(cfg_ff, want_modes=True)
    # log|amp| slope, NOT the two-pole fit: the full-f mode series rides a
    # random-walking marker-noise background (f0-level sampling, not a
    # coherent second pole), which the two-pole model misassigns (measured
    # 7% low); the slope over the exponential-dominant window is unbiased.
    # Window: from noise-floor emergence (amp >= 3x the t<5 floor, t ~ 10)
    # to trapping-saturation onset (amp <= 0.1x the saturation level,
    # t ~ 25; saturation at t ~ 28).
    ff_window = (10.0, 25.0)
    sel = (t >= ff_window[0]) & (t <= ff_window[1])
    amp_ff = np.hypot(zre[0], zim[0])
    g_ff = _log_slope(t[sel], amp_ff[sel])
    emit({"case": "two_stream_k0.2_fullf",
          "gamma_sim": g_ff, "gamma_theory": om.imag,
          "rel_err": abs(g_ff - om.imag) / abs(om.imag),
          "fit": f"mode-amplitude log-slope, window {ff_window}",
          "deltaf": False, "dtype": dtype, "bf16_weights": False,
          "backend": backend, "n_markers": n_ff, "wall_s": round(wall, 2)})
    snaps_ke = _LAST_RUN["kinetic_total"]
    e_tot = snaps_ke + e  # kinetic (all species) + field, per snapshot
    drift = float(np.max(np.abs(e_tot - e_tot[0])) / abs(e_tot[0]))
    emit({"case": "two_stream_fullf_energy_conservation",
          "max_rel_drift": drift, "rel_err": drift,
          "e_total_initial": float(e_tot[0]),
          "field_energy_peak": float(np.max(e)),
          "exchange_fraction": float(np.max(e) / abs(e_tot[0])),
          "deltaf": False, "dtype": dtype, "bf16_weights": False,
          "backend": backend, "n_markers": n_ff})

    # --- case 3c: PHYSICAL marker loading (markers ~ f0, Maxwellian only,
    # reference src/pic1dp_particle.F90:172-178) end-to-end: Landau damping
    # with p = n0 lx / N constant weights
    from pic1dp_tpu.config import MarkerLoading

    n_ph = int(float(os.environ.get(
        "PIC1DP_PHYSICS_N_PHYS", 102_400 if on_cpu else 2**24)))
    cfg_ph = landau_damping(nx=64, nparticle=n_ph, k=0.5, amp=1e-4,
                            time_max=20.0, output_interval=0.1, dtype=dtype,
                            verbosity=0, dt=0.025,
                            marker=MarkerLoading.PHYSICAL)
    om_l = Dispersion(species_for_config(cfg_ph), 0.5).solve_omega()
    t, e, wall, (zre, zim) = _run_case(cfg_ph, want_modes=True)
    ph_window = (5.0, 15.0) if on_cpu else (8.0, 18.0)
    om_fit = fit_mode_omega(t, zre[0], zim[0], window=ph_window)
    emit({"case": "landau_k0.5_physical_loading",
          "gamma_sim": om_fit.imag, "gamma_theory": om_l.imag,
          "rel_err": abs(om_fit.imag - om_l.imag) / abs(om_l.imag),
          "omega_sim": om_fit.real, "omega_theory": abs(om_l.real),
          "omega_rel_err": abs(om_fit.real - abs(om_l.real)) / abs(om_l.real),
          "fit": f"fit_mode_omega window {ph_window}",
          "marker": "physical", "dtype": dtype, "bf16_weights": False,
          "backend": backend, "n_markers": n_ph, "wall_s": round(wall, 2)})

    # --- case 4: multi-mode production path (modes 1..4, k1 = 0.1) --------
    # Box sized so modes 1-3 are strongly unstable (gamma = 0.209 / 0.284 /
    # 0.237) and mode 4 weakly (0.067).  Nonlinear run: modes 1-3 fit in
    # their linear windows vs the per-k dispersion roots; mode 4 is recorded
    # as nonlinearly SLAVED (driven by the m1+m3 / 2*m2 beats at ~gamma1+
    # gamma3, a real physical effect, not a solver artifact).  Linear run:
    # all FOUR modes evolve independently, each pinned to its root — mode
    # 4's window ends before the faster modes' sampling shadow (~A_2(t)/
    # sqrt(N)) reaches its amplitude.
    if not args.skip_multimode:
        n_mm = int(float(os.environ.get(
            "PIC1DP_PHYSICS_N_MM", 524_288 if on_cpu else 2**24)))
        mm_modes = (1, 2, 3, 4)
        k1 = 0.1
        roots = {}
        for m in mm_modes:
            roots[m] = _ts_disp(k1 * m).solve_omega()
        log("multimode theory: " + ", ".join(
            f"m{m}: {roots[m].imag:.4f}" for m in mm_modes))

        def mode_gammas(tmp, windows):
            # log|amp| slope per mode over a window where the mode's OWN
            # exponential dominates.  The per-mode series here is NOT a
            # two-pole signal: on top of the growing eigenmode it carries
            # (a) the ballistic/plasma-oscillation residue of the density
            # seed (omega ~ omega_pe, weakly damped — visible as an
            # amplitude wobble) and (b) the faster modes' sampling shadow
            # (~A_fast(t)/sqrt(N)).  A two-pole (or 4-pole) Prony fit
            # misassigns those components and returned gammas up to 2x off
            # while the LOCAL slope matched theory to <1% — the slope over
            # a vetted window averages the wobble and is unbiased.  Window
            # criteria (recorded per row): start after the seed transient
            # has phase-mixed AND the mode is >= 10x its residue floor; end
            # before the fastest mode's shadow exceeds ~2% of the mode
            # (and, nonlinear, before saturation at t ~ 38).
            od = OutputData(tmp)
            mt = od.get_mode_t()
            tv = od.get_scalar_t()[0]
            out = {}
            for m, w in windows.items():
                sel = (tv >= w[0]) & (tv <= w[1])
                amp = np.hypot(mt[m - 1][sel], mt[len(mm_modes) + m - 1][sel])
                out[m] = _log_slope(tv[sel], amp)
            return out, od, tv

        base = two_stream(nx=128, nparticle=n_mm, k=k1, v0=3.0,
                          time_max=40.0, dtype=dtype, verbosity=0,
                          output_interval=0.25)
        cfg_nl = dataclasses.replace(
            base, modes=mm_modes, init_modes=mm_modes,
            init_amp_cos=(0.0,) * 4, init_amp_sin=(1e-4, 1e-5, 1e-4, 3e-3))
        # Window ENDS by a pre-registered trapping criterion instead of
        # fixed times (a fixed m3 end at t=35 sat at omega_b/gamma = 0.62,
        # deepest into trapping onset of the three, and biased gamma low):
        # each mode's fit stops where its own measured E-field amplitude
        # gives a bounce frequency omega_b = sqrt(k_m E_m) = 0.3 gamma_m —
        # the O'Neil-type slope depression is O((omega_b/gamma)^2), so 0.3
        # bounds it below ~1% while 0.6 puts it at percent level.  Window
        # starts keep the residue/floor criteria.
        nl_starts = {1: 20.0, 2: 15.0, 3: 17.0}
        with tempfile.TemporaryDirectory() as tmp:
            t, e, wall = _run_case(cfg_nl, out_path=tmp)
            od0 = OutputData(tmp)
            mt0 = od0.get_mode_t()
            tv0 = od0.get_scalar_t()[0]
            nl_windows, wb_end = {}, {}
            for m in (1, 2, 3):
                amp_m = np.hypot(mt0[m - 1], mt0[len(mm_modes) + m - 1])
                wb = np.sqrt(k1 * m * amp_m)
                over = np.nonzero(wb > 0.3 * roots[m].imag)[0]
                t_end = float(tv0[over[0]]) if len(over) else float(tv0[-1])
                nl_windows[m] = (nl_starts[m], t_end)
                wb_end[m] = float(wb[np.argmin(np.abs(tv0 - t_end))]
                                  / roots[m].imag)
            nl_windows[4] = (30.0, 40.0)
            gam, od, tv = mode_gammas(tmp, nl_windows)
            # companion quantification: the late-window slope (a fixed
            # end t=35, omega_b/gamma ~ 0.5-0.6) minus the criterion
            # window's — the measured trapping depression itself
            late = {m: (nl_windows[m][1], 35.0) for m in (1, 2, 3)}
            gam_late = {}
            for m in (1, 2, 3):
                lo, hi = late[m]
                if hi - lo >= 2.0:
                    sel = (tv >= lo) & (tv <= hi)
                    amp = np.hypot(mt0[m - 1][sel],
                                   mt0[len(mm_modes) + m - 1][sel])
                    gam_late[m] = _log_slope(tv[sel], amp)
            for m in (1, 2, 3):
                row = {"case": f"multimode_nonlinear_m{m}_k{k1 * m:.1f}",
                       "gamma_sim": gam[m], "gamma_theory": roots[m].imag,
                       "rel_err": abs(gam[m] - roots[m].imag) / roots[m].imag,
                       "fit": f"mode-amplitude log-slope, window "
                              f"({nl_windows[m][0]}, {nl_windows[m][1]:.2f})"
                              f" (end: omega_b = 0.3 gamma from measured "
                              f"amplitude)",
                       "omega_b_over_gamma_at_window_end": wb_end[m],
                       "dtype": dtype, "bf16_weights": False,
                       "backend": backend, "n_markers": n_mm,
                       "wall_s": round(wall, 2)}
                if m in gam_late:
                    # negative = growth depressed in the trapping-onset
                    # window, the bias fixed windows fold into gamma_sim
                    row["trapping_depression_late_window"] = (
                        gam_late[m] - gam[m])
                    row["late_window"] = late[m]
                emit(row)
            # slaved mode: informational — by t = 30 the m1+m3 / 2*m2 beat
            # drive (~gamma1+gamma3) has overtaken m4's slow linear growth,
            # so its late-window slope is compared against the beat rate
            emit({"case": "multimode_nonlinear_m4_slaved",
                  "gamma_sim": gam[4], "gamma_theory": roots[4].imag,
                  "gamma_beat_drive": roots[1].imag + roots[3].imag,
                  "fit": f"mode-amplitude log-slope, window {nl_windows[4]}",
                  "informational": True, "dtype": dtype,
                  "bf16_weights": False, "backend": backend,
                  "n_markers": n_mm})
            # mode-structure correlation for two modes in the linear phase
            it = int(np.argmin(np.abs(tv - 28.0)))
            for m in (2, 3):
                corr = structure_correlation(od, it, m, _ts_disp(k1 * m))
                emit({"case": f"multimode_m{m}_mode_structure",
                      "t_snapshot": 28.0, "structure_corr": corr,
                      "rel_err": 1.0 - corr, "dtype": dtype,
                      "bf16_weights": False, "backend": backend,
                      "n_markers": n_mm})

        # m4 seeded 100x above the fast modes: linear mode is amplitude-
        # scale-invariant (v frozen, drive = p*E), so only the NOISE
        # geometry changes — by the window end m1 reaches ~3.5e-3 while m4
        # is at ~6.5e-3, keeping the fast modes' ~A_max/sqrt(N) sampling
        # shadow two decades below m4's own amplitude over the whole fit
        cfg_li = dataclasses.replace(
            base, linear=True, time_max=45.0, modes=mm_modes,
            init_modes=mm_modes, init_amp_cos=(0.0,) * 4,
            init_amp_sin=(1e-5, 1e-5, 1e-5, 1e-3))
        li_windows = {1: (22.0, 45.0), 2: (15.0, 40.0), 3: (20.0, 45.0),
                      4: (12.0, 36.0)}
        with tempfile.TemporaryDirectory() as tmp:
            t, e, wall = _run_case(cfg_li, out_path=tmp)
            gam, od, tv = mode_gammas(tmp, li_windows)
            for m in mm_modes:
                emit({"case": f"multimode_linear_m{m}_k{k1 * m:.1f}",
                      "gamma_sim": gam[m], "gamma_theory": roots[m].imag,
                      "rel_err": abs(gam[m] - roots[m].imag) / roots[m].imag,
                      "fit": f"mode-amplitude log-slope, window "
                             f"{li_windows[m]}",
                      "dtype": dtype, "bf16_weights": False,
                      "backend": backend, "n_markers": n_mm,
                      "wall_s": round(wall, 2)})

    if args.out:
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
        log(f"wrote {args.out}")

    checked = [r for r in results
               if not r.get("bf16_weights") and not r.get("informational")
               and "gamma_sim" in r]
    worst = max(r["rel_err"] for r in checked)
    log(f"worst f32/f64 gamma rel_err: {worst:.2%}")
    return 0 if worst < 0.10 else 1


if __name__ == "__main__":
    sys.exit(main())
