"""Instrumented per-phase timing of the RK2 step (wtimer parity).

The reference answers "where did the time go?" with a 12-slot cumulative
wall-clock table printed at exit (src/wtimer.F90:40-44, slot registry
src/pic1dp_global.F90:38-50, report src/pic1dp_output.F90:576-627): total,
init, load, push, shape, collect charge, field solve, optimize, output,
final, plus dedicated Allreduce/scatter communication timers.

Under jit the phases FUSE — that is the point of the design — so per-phase
numbers cannot be read off the production step.  This module rebuilds each
phase as its own jitted lax.scan and times it with the two-point scan-slope
method (time k and 3k iterations, take the slope): dispatch latency
cancels, and the np.asarray host fetch forces real execution.

When the stepper is a parallel.mesh.ShardedStepper, every phase loop runs
under shard_map on its mesh with the production shardings (particle arrays
sharded, fields replicated) and the deposition/diagnostic psums in place —
the per-phase numbers then measure the actual sharded step, collectives
included, not a single-device replica.

Attribution caveats, by design and documented here once:
  * each phase loop re-reads its inputs from HBM, while the fused step
    shares them in registers — so the phase sum exceeds the fused step time;
    both are reported, and the difference IS the measured fusion gain;
  * "shape + gather E" and "collect charge" each include the mode_trig
    evaluation the fused step shares between them (the reference's
    iptclshape=4 similarly recomputes shape inside both push and collect,
    src/pic1dp_interaction.F90:239-258, :96-114);
  * scan-carry chaining adds one O(n) reduction per phase iteration —
    negligible against the O(n) memory streams it serializes.
"""

from __future__ import annotations

import time
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np

from pic1dp_tpu.config import DepositMethod
from pic1dp_tpu.ops import spectral as spectral_ops


def _slope(build_loop, args, k: int) -> float:
    """Seconds per iteration via the two-point scan-slope method."""
    fa, fb = build_loop(k), build_loop(3 * k)
    np.asarray(fa(*args))  # compile + warm both lengths
    np.asarray(fb(*args))
    # per-side minima: latency noise is additive, so min(tb) - min(ta) is
    # robust to host hiccups that deflate the paired min_i(tb_i - ta_i)
    tas, tbs = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        np.asarray(fa(*args))
        tas.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        np.asarray(fb(*args))
        tbs.append(time.perf_counter() - t0)
    return max((min(tbs) - min(tas)) / (2 * k), 0.0)


def measure_phase_split(stepper, state, steps: int = 10) -> "OrderedDict[str, float]":
    """Per-phase seconds-per-step table for a MATRIX_FREE stepper.

    `stepper` is a core.step.Stepper (single-device loops) or a
    parallel.mesh.ShardedStepper (loops under shard_map on its mesh, psums
    included).  Returns an ordered dict phase -> seconds/step.  Phases
    executed twice per step (two RK substeps) are already doubled.  Keys
    mirror the reference's wtimer slots (push / shape / collect / field);
    extra keys report the fused production step and, on the Pallas path, the
    fused kernels themselves.
    """
    inner = getattr(stepper, "local", stepper)  # ShardedStepper holds .local
    mesh = getattr(stepper, "mesh", None)
    cfg = inner.cfg
    dt = jnp.asarray(cfg.dt, inner.dtype)
    x, v, p, w, live = state.x, state.v, state.p, state.w, state.live
    mre, mim = state.mode_re, state.mode_im

    if mesh is not None:
        from jax.sharding import PartitionSpec as P

        from pic1dp_tpu.parallel.mesh import AXIS
        from pic1dp_tpu.parallel.mesh import shard_map as _smap

        PSPEC, RSPEC = P(None, AXIS), P()

        def wrap(f, in_specs, out_specs=P()):
            return jax.jit(_smap(f, mesh, in_specs=tuple(in_specs),
                                 out_specs=out_specs))

        def red(s):
            # replicate the timing scalar so out_specs=P() is honest — also
            # the production psum the collect/solve phases pay per substep
            return jax.lax.psum(s, AXIS)
    else:
        PSPEC = RSPEC = None

        def wrap(f, in_specs, out_specs=None):
            return jax.jit(f)

        def red(s):
            return s

    def zero(dtype=x.dtype):
        return jnp.zeros((), dtype)

    # --- shape + gather E: mode_trig + efield_at (reference "shape" is
    # folded into push/collect under iptclshape=4; we report it with the
    # gather, where it dominates) --------------------------------------
    def build_gather(k):
        def run(x, mre, mim):
            def body(c, _):
                t = inner._trig(x + c)
                e = spectral_ops.efield_at(t, mre, mim)
                return jnp.asarray(1e-30, e.dtype) * jnp.sum(e), None
            out, _ = jax.lax.scan(body, zero(), None, length=k)
            return red(out)
        return wrap(run, (PSPEC, RSPEC, RSPEC))

    # --- push: the x/w/v update math given the gathered field
    # (reference interaction_push_particle body, :260-338) ---------------
    e_p = wrap(lambda x, mre, mim: spectral_ops.efield_at(
        inner._trig(x), mre, mim), (PSPEC, RSPEC, RSPEC),
        out_specs=PSPEC)(x, mre, mim)

    def build_push(k):
        def run(e_p, x, v, p, w):
            def body(c, _):
                # carry feeds BOTH e_p and x so no update is loop-invariant
                # (XLA hoists invariant computations out of the scan)
                x2, v2, w2 = inner._push_math(
                    e_p + c, x + c, v, p, w, x + c, v, w, dt)
                s = jnp.sum(x2) + jnp.sum(v2) + jnp.sum(w2)
                return jnp.asarray(1e-30, s.dtype) * s, None
            out, _ = jax.lax.scan(body, zero(e_p.dtype), None, length=k)
            return red(out)
        return wrap(run, (PSPEC,) * 5)

    # --- collect charge: mode_trig + mode projections + (sharded) psum
    # (reference interaction_collect_charge, :96-135) ---------------------
    def build_collect(k):
        def run(x, p, w, live):
            def body(c, _):
                t = inner._trig(x + c)
                pc, ps = spectral_ops.project_modes(
                    t, inner._deposit_val(p, w, live))
                s = red(jnp.sum(pc) + jnp.sum(ps))
                return jnp.asarray(1e-30, s.dtype) * s, None
            out, _ = jax.lax.scan(body, zero(), None, length=k)
            return out
        return wrap(run, (PSPEC,) * 4)

    # --- field solve: projections -> E-mode components -> grid E
    # (reference field_solve_electric, src/pic1dp_field.F90:218-257) ------
    pc0, ps0 = wrap(
        lambda x, p, w, live: tuple(
            red(a) for a in spectral_ops.project_modes(
                inner._trig(x), inner._deposit_val(p, w, live))),
        (PSPEC,) * 4, out_specs=(RSPEC, RSPEC))(x, p, w, live)

    def build_solve(k):
        def run(pc, ps):
            def body(c, _):
                mre2, mim2 = spectral_ops.solve_modes_from_projections(
                    pc + c, ps, inner.spectral.grad_inv, cfg.lx)
                e = inner.spectral.e_grid(mre2, mim2)
                s = jnp.sum(e)
                return jnp.asarray(1e-30, s.dtype) * s, None
            out, _ = jax.lax.scan(body, zero(pc.dtype), None, length=k)
            return out
        return wrap(run, (RSPEC, RSPEC))

    # --- the fused production step, for the fusion-gain row --------------
    def build_step(k):
        multi = stepper.make_multi_step(k)

        @jax.jit
        def run(state):
            out = multi(state)
            # reduce to one scalar that depends on every output so the host
            # fetch forces the whole computation (np.asarray of a SimState
            # would not)
            return (jnp.sum(out.electric) + jnp.sum(out.x)
                    + jnp.sum(out.v) + jnp.sum(out.w))
        return run

    table: "OrderedDict[str, float]" = OrderedDict()
    table["push particle"] = 2.0 * _slope(build_push, (e_p, x, v, p, w), steps)
    table["shape + gather E"] = 2.0 * _slope(build_gather, (x, mre, mim), steps)
    table["collect charge"] = 2.0 * _slope(build_collect, (x, p, w, live), steps)
    table["field solve"] = 2.0 * _slope(build_solve, (pc0, ps0), 64 * steps)

    # Pallas path: time the fused kernels themselves as well
    if inner.deposit_method == DepositMethod.PALLAS:
        fused = inner._get_fused()

        def build_ss1(k):
            def run(x, v, p, w, mre, mim):
                def body(c, _):
                    pc, ps = fused.substep1(x + c, v, p, w, mre, mim)
                    s = red(jnp.sum(pc) + jnp.sum(ps))
                    return jnp.asarray(1e-30, x.dtype) * s.astype(x.dtype), None
                out, _ = jax.lax.scan(body, zero(), None, length=k)
                return out
            return wrap(run, (PSPEC,) * 4 + (RSPEC, RSPEC))

        def build_ss2(k):
            def run(x, v, p, w, mre, mim):
                def body(c, _):
                    _x2, _v2, _w2, (pc, ps) = fused.substep2(
                        x + c, v, p, w, mre, mim, mre, mim)
                    s = red(jnp.sum(pc) + jnp.sum(ps))
                    return jnp.asarray(1e-30, x.dtype) * s.astype(x.dtype), None
                out, _ = jax.lax.scan(body, zero(), None, length=k)
                return out
            return wrap(run, (PSPEC,) * 4 + (RSPEC, RSPEC))

        table["substep-1 kernel (fused)"] = _slope(
            build_ss1, (x, v, p, w, mre, mim), steps)
        table["substep-2 kernel (fused)"] = _slope(
            build_ss2, (x, v, p, w, mre, mim), steps)

    table["sum of phases (unfused)"] = (
        table["push particle"] + table["shape + gather E"]
        + table["collect charge"] + table["field solve"])
    table["full step (measured)"] = _slope(build_step, (state,), steps)
    return table


def format_phase_table(table: "OrderedDict[str, float]") -> str:
    """Render the per-phase table (reference output_wtimer,
    src/pic1dp_output.F90:576-627 layout: name, time, % of total)."""
    total = table.get("full step (measured)", 0.0)
    # sub-microsecond totals mean the slope was lost in host noise (tiny CPU
    # cases); print absolute times and skip the meaningless percentages
    denom = total if total > 1e-6 else float("inf")
    lines = ["Info: per-phase step decomposition (scan-slope method):",
             f"{'phase':>26} {'ms/step':>10} {'% of step':>10}"]
    for name, sec in table.items():
        lines.append(f"{name:>26} {sec * 1e3:10.4f} "
                     f"{100.0 * sec / denom:9.1f}%")
    gain = table.get("sum of phases (unfused)", 0.0) - total
    lines.append(f"{'fusion gain':>26} {gain * 1e3:10.4f} "
                 f"{100.0 * gain / denom:9.1f}%")
    return "\n".join(lines)
