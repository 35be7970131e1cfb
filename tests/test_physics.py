"""Physics integration tests: growth/damping rates vs kinetic theory.

The reference's verification methodology (SURVEY.md section 4): measure
gamma = d ln(int E^2 dx)/dt / 2 from the simulation (reference
tools/runinfo.py:116) and compare against the dispersion-relation root
(reference tools/dispersion.py).  Tolerances cover finite-marker noise and
finite-dt at the reduced test sizes (the full-size cases in BASELINE.md
match to well under the tolerances used here).
"""

import numpy as np
import pytest

from pic1dp_tpu import Simulation
from pic1dp_tpu.analysis.dispersion import Dispersion, species_for_config
from pic1dp_tpu.config import bump_on_tail_default, landau_damping, two_stream


def _run(cfg):
    snaps = []
    Simulation(cfg).run(snapshot_callback=snaps.append)
    t = np.array([s["time"] for s in snaps])
    e = np.array([s["field_energy"] for s in snaps])
    _run.last_snaps = snaps
    return t, e


def _gamma_fit(t, e, t1, t2):
    m = (t >= t1) & (t <= t2)
    return np.polyfit(t[m], np.log(e[m]), 1)[0] / 2.0


def _gamma_peaks(t, e, t1, t2):
    """Fit through the local maxima of the oscillating field energy (for
    damped oscillations, where the raw fit is biased by the zero crossings)."""
    pk = [i for i in range(1, len(e) - 1)
          if e[i] > e[i - 1] and e[i] > e[i + 1] and t1 <= t[i] <= t2]
    return np.polyfit(t[pk], np.log(e[pk]), 1)[0] / 2.0


def test_landau_damping_rate():
    cfg = landau_damping(nx=64, nparticle=100_000, k=0.5, amp=1e-4,
                         time_max=20.0, dtype="float64", verbosity=0,
                         output_interval=0.1)
    omega = Dispersion(species_for_config(cfg), 0.5).solve_omega()
    assert omega == pytest.approx(1.4157 - 0.1534j, abs=1e-3)
    t, e = _run(cfg)
    gamma = _gamma_peaks(t, e, 1.0, 15.0)
    assert gamma == pytest.approx(omega.imag, rel=0.04)
    # the two-pole mode-amplitude fit recovers BOTH gamma and omega_r
    # (the peaks fit above can't see omega_r at all)
    from pic1dp_tpu.analysis.dispersion import fit_mode_omega

    snaps = _run.last_snaps
    zre = np.array([s["mode_re"][0] for s in snaps])
    zim = np.array([s["mode_im"][0] for s in snaps])
    om_fit = fit_mode_omega(t, zre, zim, window=(5.0, 15.0))
    assert om_fit.imag == pytest.approx(omega.imag, rel=0.03)
    assert om_fit.real == pytest.approx(omega.real, rel=0.01)


def test_bump_on_tail_growth_rate():
    cfg = bump_on_tail_default(nparticle_max=200_000, time_max=70.0,
                               dtype="float64", verbosity=0,
                               output_interval=1.0)
    k = 2.0 * np.pi / cfg.lx
    omega = Dispersion(species_for_config(cfg), k).solve_omega()
    assert omega.imag == pytest.approx(0.08383, abs=1e-4)
    t, e = _run(cfg)
    gamma = _gamma_fit(t, e, 25.0, 60.0)
    assert gamma == pytest.approx(omega.imag, rel=0.08)


def test_two_stream_growth_rate():
    cfg = two_stream(nparticle=200_000, time_max=26.0, dtype="float64",
                     verbosity=0, output_interval=0.5)
    disp = Dispersion(species_for_config(cfg), 0.2)
    disp._guesses = [0.01 + 0.3j, 0.02 + 0.5j, 0.05 + 0.4j]
    omega = disp.solve_omega()
    assert omega.imag == pytest.approx(0.28451, abs=1e-4)
    t, e = _run(cfg)
    gamma = _gamma_fit(t, e, 10.0, 25.0)
    assert gamma == pytest.approx(omega.imag, rel=0.08)
    # conservation oracle (SURVEY.md section 4 item 5): total energy
    # E = KE/2 + int E^2 dx / 2 must be conserved by the RK2 push to a
    # small fraction of the kinetic energy
    snaps = _run.last_snaps
    ke = np.array([float(np.sum(s["total"])) for s in snaps])
    etot = 0.5 * ke + 0.5 * e
    assert np.max(np.abs(etot - etot[0])) / ke[0] < 1e-4


def test_fullf_matches_deltaf_when_signal_dominates():
    """full-f and delta-f solve the same Vlasov-Poisson system; with the
    seed amplitude well above the full-f equilibrium sampling noise
    (sigma ~ lx/sqrt(2N)) the field-energy histories must agree."""
    import dataclasses

    base = landau_damping(nx=32, nparticle=400_000, amp=1e-1, time_max=2.0,
                          output_interval=0.25, dtype="float64", verbosity=0)
    t, e_df = _run(base)
    _, e_ff = _run(dataclasses.replace(base, deltaf=False))
    assert np.max(np.abs(e_ff - e_df)) / np.max(e_df) < 0.06


def test_linear_mode_matches_nonlinear_at_small_amplitude():
    """cfg.linear freezes v and drives w with p*E (reference
    src/pic1dp_interaction.F90:267-271); at 1e-4 seed amplitude the linear
    and nonlinear damping rates must coincide."""
    import dataclasses

    base = landau_damping(nx=64, nparticle=50_000, k=0.5, amp=1e-4,
                          time_max=15.0, output_interval=0.1,
                          dtype="float64", verbosity=0)
    t, e_nl = _run(base)
    t, e_li = _run(dataclasses.replace(base, linear=True))
    g_nl = _gamma_peaks(t, e_nl, 1.0, 12.0)
    g_li = _gamma_peaks(t, e_li, 1.0, 12.0)
    assert g_li == pytest.approx(g_nl, rel=0.02)
    assert g_li == pytest.approx(-0.1534, rel=0.06)


def test_two_maxwellian_species_match_two_stream_equilibrium():
    """Multi-species parity: two counter-streaming Maxwellian SPECIES must
    reproduce the growth rate of the built-in two-stream2 EQUILIBRIUM (a
    pair of counter-streaming Maxwellian components inside one species) —
    the same physical system expressed through the nspecies axis."""
    from pic1dp_tpu.config import Config, Equilibrium, SpeciesConfig

    cfg = Config(
        linear=False,
        lx=2.0 * np.pi / 0.2,
        equilibrium=Equilibrium.MAXWELLIAN,
        species=(
            SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.0,
                          density=0.5, v0=3.0),
            SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.0,
                          density=0.5, v0=-3.0),
        ),
        nx=256,
        nparticle_max=100_000,   # per species
        time_max=26.0,
        output_interval=0.5,
        dtype="float64",
        verbosity=0,
    ).validate()
    t, e = _run(cfg)
    gamma = _gamma_fit(t, e, 10.0, 25.0)
    assert gamma == pytest.approx(0.28451, rel=0.09)


def test_multimode_growth_and_structure():
    """Multi-mode production path: one nonlinear
    run keeping modes (1, 2, 3) — box k1 = 0.1, all three strongly unstable
    with distinct rates — must grow EACH mode at its own dispersion root
    (per-k partial-DFT solve + multi-mode trig recurrence validated at
    physics level), and the delta-f(x, v) snapshot in the late linear phase
    must match the analytic eigenmode structure (reference mode-structure
    plot, tools/dispersion.py:159-206, as a correlation metric)."""
    import dataclasses
    import tempfile

    from pic1dp_tpu.analysis.dispersion import structure_correlation
    from pic1dp_tpu.analysis.output_data import OutputData

    k1 = 0.1
    base = two_stream(nx=128, nparticle=131_072, k=k1, v0=3.0,
                      time_max=35.0, dtype="float64", verbosity=0,
                      output_interval=0.25)
    cfg = dataclasses.replace(
        base, modes=(1, 2, 3), init_modes=(1, 2, 3),
        init_amp_cos=(0.0,) * 3, init_amp_sin=(1e-4, 1e-5, 1e-4))
    disps = {}
    for m in (1, 2, 3):
        d = Dispersion(species_for_config(cfg), k1 * m)
        d._guesses = [0.01 + 0.3j, 0.02 + 0.5j, 0.05 + 0.4j]
        disps[m] = d
    theory = {m: disps[m].solve_omega().imag for m in (1, 2, 3)}
    assert theory[1] == pytest.approx(0.20867, abs=1e-4)
    assert theory[2] == pytest.approx(0.28451, abs=1e-4)
    assert theory[3] == pytest.approx(0.23693, abs=1e-4)

    with tempfile.TemporaryDirectory() as tmp:
        Simulation(cfg, out_path=tmp).run()
        od = OutputData(tmp)
        t = od.get_scalar_t()[0]
        mt = od.get_mode_t()
        for m, tol in ((1, 0.10), (2, 0.05), (3, 0.05)):
            amp = np.hypot(mt[m - 1], mt[3 + m - 1])
            sel = (t >= 15.0) & (t <= 34.0)
            gamma = np.polyfit(t[sel], np.log(amp[sel]), 1)[0]
            assert gamma == pytest.approx(theory[m], rel=tol), f"mode {m}"
        # mode-structure correlation at t = 28 (linear phase, amplitude
        # well above marker noise): >= 0.99 after projecting out the
        # arbitrary complex phase/amplitude
        it = int(np.argmin(np.abs(t - 28.0)))
        for m in (2, 3):
            corr = structure_correlation(od, it, m, disps[m])
            assert corr > 0.99, f"mode {m} structure corr {corr}"


def test_two_stream1_growth_rate():
    """The two_stream1 equilibrium (v^2 Maxwellian, reference iptcldist=1)
    against its Z-function dispersion relation.  Note: like the reference's
    own -f0'/f0 = v - 2/v (src/pic1dp_interaction.F90:276), the weight push
    is singular at v=0, so the scheme is only valid pre-saturation; the
    divergence guard catches the post-saturation blow-up."""
    from pic1dp_tpu.analysis.dispersion import muller, two_stream1_dispfunc
    from pic1dp_tpu.config import Config, Equilibrium, SpeciesConfig

    k = 0.5
    omega = muller(two_stream1_dispfunc(k), 0.05 + 0.2j, 0.1 + 0.3j,
                   0.02 + 0.25j)
    assert omega.imag == pytest.approx(0.25925, abs=1e-4)
    cfg = Config(
        linear=False, lx=2.0 * np.pi / k,
        equilibrium=Equilibrium.TWO_STREAM1,
        species=(SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.0,
                               density=1.0, v0=0.0),),
        nx=64, nparticle_max=100_000, time_max=22.0, v_max=8.0,
        dtype="float64", verbosity=0, output_interval=0.5,
    ).validate()
    t, e = _run(cfg)
    gamma = _gamma_fit(t, e, 8.0, 20.0)
    assert gamma == pytest.approx(omega.imag, rel=0.08)
