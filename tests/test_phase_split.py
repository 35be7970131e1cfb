"""The instrumented phase-split mode (wtimer-parity table,
reference src/pic1dp_output.F90:576-627) must produce a complete, finite
table for both the XLA spectral and the Pallas stepper configurations."""

import dataclasses

import jax
import numpy as np

from pic1dp_tpu.config import DepositMethod, bump_on_tail_default
from pic1dp_tpu.core.loading import load_particles
from pic1dp_tpu.core.step import Stepper
from pic1dp_tpu.utils.phase_split import (format_phase_table,
                                          measure_phase_split)

_ROWS = ("push particle", "shape + gather E", "collect charge",
         "field solve", "sum of phases (unfused)", "full step (measured)")


def test_phase_split_xla_path():
    cfg = bump_on_tail_default(nx=192, nparticle_max=65536, dtype="float64",
                               verbosity=0)
    st = Stepper(cfg)
    state = st.initial_field(load_particles(cfg, jax.random.PRNGKey(0)))
    table = measure_phase_split(st, state, steps=4)
    for row in _ROWS:
        assert row in table, row
        assert np.isfinite(table[row]) and table[row] >= 0.0, row
    text = format_phase_table(table)
    assert "fusion gain" in text and "% of step" in text


def test_phase_split_pallas_rows():
    cfg = bump_on_tail_default(nx=192, nparticle_max=4096, dtype="float64",
                               deposit_method=DepositMethod.PALLAS,
                               verbosity=0)
    st = Stepper(cfg, interpret=True)
    assert st.deposit_method == DepositMethod.PALLAS
    state = st.initial_field(load_particles(cfg, jax.random.PRNGKey(1)))
    table = measure_phase_split(st, state, steps=2)
    assert "substep-1 kernel (fused)" in table
    assert "substep-2 kernel (fused)" in table
    for v in table.values():
        assert np.isfinite(v) and v >= 0.0


def test_phase_split_sharded_mesh():
    """Under a mesh the table must measure the SHARDED step (shard_mapped
    phase loops with the production psums), not a single-device replica."""
    from pic1dp_tpu.parallel import mesh as pmesh

    cfg = bump_on_tail_default(nx=64, nparticle_max=8 * 8192,
                               dtype="float64", verbosity=0)
    mesh = pmesh.make_mesh(8)
    st = pmesh.ShardedStepper(cfg, mesh)
    state = pmesh.shard_state(load_particles(cfg, jax.random.PRNGKey(2)), mesh)
    state = st.initial_field(state)
    table = measure_phase_split(st, state, steps=2)
    for row in _ROWS:
        assert row in table, row
        assert np.isfinite(table[row]) and table[row] >= 0.0, row
    # on the CPU test backend AUTO resolves to the XLA step, so the fused
    # kernel rows are absent
    assert "substep-1 kernel (fused)" not in table
    text = format_phase_table(table)
    assert "fusion gain" in text


def test_simulation_phase_table_and_timers():
    from pic1dp_tpu import Simulation

    cfg = bump_on_tail_default(nx=64, nparticle_max=16384, time_max=0.25,
                               output_interval=0.25, dtype="float64",
                               verbosity=0)
    sim = Simulation(cfg)
    sim.run()
    report = sim.timers.report()
    for phase in ("initialize", "particle load", "step", "output", "total"):
        assert phase in report, phase
    text = sim.phase_table(steps=2)
    assert "collect charge" in text


def test_optimization_path_timer_rows():
    """The scheduled-optimization path surfaces its sub-phases (push pair /
    optimize / collect+solve) in the timer table, nested under "step"."""
    from pic1dp_tpu import Simulation
    from pic1dp_tpu.config import OptimizationConfig

    cfg = bump_on_tail_default(
        nx=64, nparticle_max=16384, time_max=0.25, output_interval=0.25,
        dtype="float64", verbosity=0,
        optimization=OptimizationConfig(tmerge=(0.1,), thshmerge=(0.5,)))
    sim = Simulation(cfg)
    sim.run()
    report = sim.timers.report()
    for phase in ("step: push pair", "optimize particle",
                  "step: collect + solve"):
        assert phase in report, phase
