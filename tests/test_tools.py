"""Tool-layer tests: writer -> OutputData round trip, analysis accessors,
runinfo/ptcldist/run CLIs, checkpoint/resume."""

import dataclasses
import os
import subprocess
import sys

# Subprocesses run `-m pic1dp_tpu...` with cwd=_REPO so the package resolves
# from sys.path[0].
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import jax
import numpy as np
import pytest

from pic1dp_tpu import Simulation
from pic1dp_tpu.analysis.output_data import OutputData
from pic1dp_tpu.config import landau_damping


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("run")
    cfg = landau_damping(nx=32, nparticle=4096, time_max=2.0,
                         output_interval=0.5, dtype="float64", verbosity=0,
                         nv=32, nx_opd=16, nv_opd=16)
    sim = Simulation(cfg, out_path=str(out))
    sim.run()
    return cfg, str(out)


def test_output_roundtrip(small_run):
    cfg, out = small_run
    data = OutputData(out)
    assert data.nspecies == 1
    assert data.nx == cfg.nx
    assert data.nx_pd == cfg.nx_opd and data.nv_pd == cfg.nv_opd
    assert list(data.mode) == list(cfg.modes)
    assert data.ntime == 5  # t = 0, 0.5, 1.0, 1.5, 2.0
    scalar_t = data.get_scalar_t()
    np.testing.assert_allclose(scalar_t[0], [0.0, 0.5, 1.0, 1.5, 2.0],
                               atol=1e-9)
    assert np.all(scalar_t[1] > 0)          # field energy
    mode_t = data.get_mode_t()
    assert mode_t.shape == (2, data.ntime)
    field = data.get_field_x(0)
    assert field.shape == (2, cfg.nx + 1)
    np.testing.assert_allclose(field[:, -1], field[:, 0])  # periodic closure
    xv = data.get_ptcldist_xv(0, 0, 2)
    assert xv.shape == (cfg.nv_opd, cfg.nx_opd + 1)
    v = data.get_ptcldist_v(0, 0, 0)
    assert v.shape == (cfg.nv_opd,)
    assert np.all(v >= 0)                   # marker distribution
    # energy fit over the whole run must be finite
    assert np.isfinite(data.growthrate_energy_fit(0.0, 2.0))
    t_pk, e_pk = data.findpeak_energy(0.0, 2.0)
    assert 0.0 <= t_pk <= 2.0 and e_pk > 0


def test_runinfo_cli(small_run):
    _, out = small_run
    res = subprocess.run(
        [sys.executable, "-m", "pic1dp_tpu.analysis.runinfo",
         "-gr", "0", "2", "-sr", "0", "2", out, out],
        capture_output=True, text=True, timeout=300, cwd=_REPO)
    assert res.returncode == 0, res.stderr
    assert "growth rate" in res.stdout
    assert "saturation level" in res.stdout


def test_ptcldist_cli(small_run, tmp_path, monkeypatch):
    _, out = small_run
    monkeypatch.chdir(tmp_path)
    res = subprocess.run(
        [sys.executable, "-m", "pic1dp_tpu.analysis.ptcldist", out,
         "-t", "0", "-d", "0", "-o", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=_REPO)
    assert res.returncode == 0, res.stderr
    arr = np.loadtxt(tmp_path / "ptcldist_xv.dat")
    assert arr.shape == (16, 17)


def test_run_cli_write_config(tmp_path):
    cfg_file = tmp_path / "cfg.json"
    res = subprocess.run(
        [sys.executable, "-m", "pic1dp_tpu.run", "-p", "landau",
         "-s", "nx=16", "--write-config", str(cfg_file)],
        capture_output=True, text=True, timeout=300, cwd=_REPO)
    assert res.returncode == 0, res.stderr
    from pic1dp_tpu.config import Config

    cfg = Config.from_json(cfg_file.read_text())
    assert cfg.nx == 16


def test_checkpoint_resume(tmp_path):
    cfg = landau_damping(nx=32, nparticle=4096, time_max=2.0,
                         output_interval=0.5, dtype="float64", verbosity=0,
                         nv=32, nx_opd=16, nv_opd=16)
    # continuous run to t = 2
    sim_a = Simulation(cfg)
    sim_a.load()
    while sim_a.time < 2.0 - 1e-9:
        sim_a.step_once()

    # run to t = 1, checkpoint, restore into a fresh Simulation, continue
    sim_b = Simulation(cfg)
    sim_b.load()
    while sim_b.time < 1.0 - 1e-9:
        sim_b.step_once()
    ck = sim_b.save_checkpoint(str(tmp_path / "ck.npz"))
    sim_c = Simulation(cfg)
    sim_c.restore_checkpoint(ck)
    assert sim_c.itime == sim_b.itime
    while sim_c.time < 2.0 - 1e-9:
        sim_c.step_once()

    for f in ("x", "v", "w", "electric"):
        np.testing.assert_array_equal(
            np.asarray(getattr(sim_a.state, f)),
            np.asarray(getattr(sim_c.state, f)), err_msg=f)


def test_checkpoint_config_mismatch(tmp_path):
    """State-affecting config changes are rejected; run-control changes
    (extending time_max, output cadence) are exactly what resume is for."""
    cfg = landau_damping(nx=32, nparticle=4096, dtype="float64", verbosity=0)
    sim = Simulation(cfg)
    sim.load()
    ck = sim.save_checkpoint(str(tmp_path / "ck.npz"))
    with pytest.raises(ValueError, match="different config"):
        Simulation(dataclasses.replace(cfg, nx=64)).restore_checkpoint(ck)
    extended = Simulation(dataclasses.replace(cfg, time_max=50.0,
                                              output_interval=1.0))
    extended.restore_checkpoint(ck)
    assert extended.itime == sim.itime


def test_chunked_run_matches_per_step():
    """The lax.scan chunked main loop must reproduce the per-step loop."""
    cfg = landau_damping(nx=32, nparticle=4096, time_max=1.0,
                         output_interval=0.25, dtype="float64", verbosity=0)
    sim_a = Simulation(cfg)
    sim_a.run()
    sim_b = Simulation(cfg)
    sim_b.load()
    while not sim_b._check_termination():
        sim_b.step_once()
    np.testing.assert_array_equal(np.asarray(sim_a.state.x),
                                  np.asarray(sim_b.state.x))
    assert sim_a.itime == sim_b.itime
    assert sim_a.time == pytest.approx(sim_b.time)


def test_multirand_backend_deterministic_loading():
    """rng backend 'multirand' with a constant seed loads identical markers
    across runs and across emulated rank counts ONLY when the rank layout
    matches (rank-block ownership changes the draw order, as in the
    reference)."""
    import dataclasses

    from pic1dp_tpu.config import RngConfig
    from pic1dp_tpu.core.loading import load_particles

    cfg = landau_damping(nx=32, nparticle=8192, dtype="float64", verbosity=0)
    cfg = dataclasses.replace(cfg, rng=RngConfig(backend="multirand"))
    a = load_particles(cfg, emulate_ranks=4)
    b = load_particles(cfg, emulate_ranks=4)
    np.testing.assert_array_equal(np.asarray(a.x), np.asarray(b.x))
    np.testing.assert_array_equal(np.asarray(a.v), np.asarray(b.v))
    c = load_particles(cfg, emulate_ranks=2)
    assert not np.array_equal(np.asarray(a.x), np.asarray(c.x))


def test_diag_full_rho(tmp_path):
    """diag_full_rho=True writes the full deposited grid charge (all
    spatial modes) instead of the kept-mode reconstruction."""
    import dataclasses

    cfg = landau_damping(nx=32, nparticle=8192, time_max=0.5,
                         output_interval=0.25, dtype="float64", verbosity=0,
                         nx_opd=16, nv_opd=16)
    cfg_full = dataclasses.replace(cfg, diag_full_rho=True)
    Simulation(cfg, out_path=str(tmp_path / "a")).run()
    Simulation(cfg_full, out_path=str(tmp_path / "b")).run()
    rho_kept = OutputData(str(tmp_path / "a")).get_field_x(0)[1]
    rho_full = OutputData(str(tmp_path / "b")).get_field_x(0)[1]
    # kept-mode rho is exactly the mode-1 projection of the full rho
    k1 = np.exp(2j * np.pi * np.arange(32) / 32)
    proj_full = 2.0 * np.real(np.mean(rho_full[:32] * np.conj(k1)) * k1)
    np.testing.assert_allclose(rho_kept[:32], proj_full, atol=1e-10)
    assert not np.allclose(rho_kept, rho_full)


def test_visual_app_headless(small_run):
    """The interactive viewer must build all panels headlessly (Agg)."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    from pic1dp_tpu.analysis.visual import VisualApp

    _, out = small_run
    app = VisualApp(out)
    app.itime = 2
    app.twindow = (0.5, 2.0)
    app.update_all()
    app._on_dist("total f")
    app._on_mode("mode 1")
    assert app.fig is not None
    import matplotlib.pyplot as plt

    plt.close(app.fig)


def test_visual_dispersion_headless():
    import matplotlib

    matplotlib.use("Agg", force=True)
    import numpy as np

    from pic1dp_tpu.analysis.dispersion import Dispersion, Species
    from pic1dp_tpu.analysis.visual_dispersion import VisualDispersion

    disp = Dispersion([Species(-1, 1, 1, 1, 0)], 0.5)
    ks = np.linspace(0.3, 0.6, 7)
    omegas = disp.scan_k(ks)
    app = VisualDispersion(disp, ks, omegas)
    app._on_species("species 0")
    import matplotlib.pyplot as plt

    plt.close(app.fig)


def test_divergence_detection():
    """A diverging run (absurd dt) must raise at the next snapshot instead
    of writing garbage (failure detection the reference lacks)."""
    import dataclasses

    cfg = landau_damping(nx=32, nparticle=4096, amp=1.0, time_max=50.0,
                         dtype="float64", verbosity=0, output_interval=10.0)
    cfg = dataclasses.replace(cfg, dt=5.0)
    with pytest.raises(FloatingPointError, match="diverged"):
        Simulation(cfg).run()


def test_sharded_checkpoint_roundtrip(tmp_path):
    """Per-process (sharded) checkpoint format round-trips on a mesh."""
    from pic1dp_tpu.parallel import mesh as pmesh

    cfg = landau_damping(nx=32, nparticle=8192, time_max=1.0,
                         dtype="float64", verbosity=0)
    sim = Simulation(cfg, mesh=8)
    sim.load()
    sim.step_once()
    ck = sim.save_checkpoint(str(tmp_path / "ck.npz"), force_sharded=True)
    assert ck.endswith(".proc0.npz")
    sim2 = Simulation(cfg, mesh=8)
    sim2.restore_checkpoint(str(tmp_path / "ck.npz"))
    for f in ("x", "v", "w", "electric"):
        np.testing.assert_array_equal(np.asarray(getattr(sim2.state, f)),
                                      np.asarray(getattr(sim.state, f)))
    sim2.step_once()  # must be steppable after restore


def test_fit_mode_omega_synthetic():
    """Two-pole TLS fit (analysis.dispersion.fit_mode_omega): exact on the
    noiseless standing-wave model, and stays within ~1% of gamma at an
    end-of-window noise-to-signal ratio of ~1% (where plain LS linear
    prediction is off by ~10% — the errors-in-variables bias)."""
    import numpy as np

    from pic1dp_tpu.analysis.dispersion import fit_mode_omega

    om_true, g_true = 1.4157, -0.1534
    t = np.arange(0.0, 15.0, 0.1)
    z = ((0.7 * np.exp(-1j * om_true * t)
          + 0.45 * np.exp(1j * (om_true * t + 0.3)))
         * np.exp(g_true * t) * 1e-4)

    om = fit_mode_omega(t, z.real, z.imag, window=(1.0, 14.0))
    assert abs(om.imag - g_true) < 1e-10
    assert abs(om.real - om_true) < 1e-10

    rng = np.random.default_rng(0)
    zz = z + 1e-7 * (rng.normal(size=t.size) + 1j * rng.normal(size=t.size))
    om = fit_mode_omega(t, zz.real, zz.imag, window=(1.0, 14.0))
    assert abs(om.imag - g_true) / abs(g_true) < 0.015
    assert abs(om.real - om_true) / om_true < 0.005

    # growing non-propagating branch (two-stream-like: omega_r = 0, poles
    # e^{+-gamma t}): early cosh shape would bias a log|amp| slope to ~0;
    # the two-pole fit must take the dominant root, not average
    g2 = 0.0672
    zg = (0.5 * np.exp(g2 * t) + 0.5 * np.exp(-g2 * t)) * 1e-4 * (1 + 0.2j)
    om = fit_mode_omega(t, zg.real, zg.imag, window=(0.0, 14.0))
    assert abs(om.imag - g2) / g2 < 1e-8
    assert abs(om.real) < 1e-8


def test_ion_acoustic_dispersion_root():
    """Electron + heavy-ion (m_i = 25, T_i/T_e = 0.05) kinetic dispersion:
    the ion-acoustic root at k = 0.5 from the same Z-function/Muller oracle
    that anchors the on-chip ion_acoustic_k0.5_mi25 physics row.  Golden
    value cross-checked against omega ~ k cs/sqrt(1 + k^2 lambda_De^2) with
    kinetic corrections (cs = sqrt(Te/mi) = 0.2)."""
    from pic1dp_tpu.analysis.dispersion import Dispersion, Species

    d = Dispersion([Species(-1, 1, 1, 1, 0), Species(1, 25, 0.05, 1, 0)],
                   0.5)
    d._guesses = [0.098 - 0.008j, 0.118 - 0.010j, 0.078 - 0.006j]
    om = d.solve_omega()
    assert abs(om - (0.09842574923689 - 0.00773636470953j)) < 1e-9
    # fluid estimate sanity: omega_r within 15% of k cs / sqrt(1 + k^2)
    fluid = 0.5 * 0.2 / (1 + 0.25) ** 0.5
    assert abs(om.real - fluid) / fluid < 0.15
