"""The RK2 time step: gather -> push -> deposit -> spectral solve.

Reference semantics (src/pic1dp.F90:78-109 main loop,
src/pic1dp_interaction.F90 push/deposit, src/pic1dp_field.F90 solve):

Per step, two Runge-Kutta (midpoint) substeps.  Substep 1 integrates from the
step-start backups with dt/2; substep 2 re-integrates from the same backups
with the full dt using midpoint fields/velocities
(reference src/pic1dp_interaction.F90:178-193).  Within a substep the update
order matters and is preserved exactly (:238-339):

    E_p   = gather(E, x)                      # hat weights at current x
    x_new = x_bak + dt_eff * v                # current v (midpoint v in ss2)
    w_new = w_bak + dt_eff * drive * (-f0'/f0)(v) * (q/m)   # delta-f only
            drive = p * E_p (linear) or (p - w) * E_p (nonlinear)
    v_new = v_bak + dt_eff * E_p * (q/m)      # nonlinear only (v frozen if linear)

then charge deposition (delta-f: w; full-f: p then subtract equilibrium,
reference src/pic1dp_interaction.F90:51-70,142-148) and the partial-DFT field
solve.  Both substeps live inside ONE jitted function, so the x/v/w backups
(reference Vecs src/pic1dp_particle.F90:34-36) are compiler temporaries.

The step is written on stacked (nspecies, nparticle) arrays; with the
particle axis sharded, the deposition reduction becomes local partial sums +
a psum — the equivalent of the reference's replicate-and-MPI_Allreduce
deposition (src/pic1dp_interaction.F90:130-135).  On a GPU the matrix-free
step runs as two fused Triton kernels (ops/pallas_kernels.py); the plain
XLA step below is the path elsewhere and the kernels' reference.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from pic1dp_tpu import distributions as dist
from pic1dp_tpu.config import Config, DepositMethod, ParticleShape
from pic1dp_tpu.core import diagnostics
from pic1dp_tpu.core.state import SimState
from pic1dp_tpu.ops import deposit as deposit_ops
from pic1dp_tpu.ops import gather as gather_ops
from pic1dp_tpu.ops import shape_matrix as shape_ops
from pic1dp_tpu.ops import spectral as spectral_ops
from pic1dp_tpu.ops.interp import wrap_x
from pic1dp_tpu.ops.spectral import SpectralOperator


def _auto_method(cfg: Config) -> DepositMethod:
    """Resolve DepositMethod.AUTO from what the code can observe.

    Matrix-free shape: the fused Triton kernels wherever they compile (a
    GPU backend); they beat XLA's step 2.8-3.0x on the H100 in every
    measured configuration (PERF.md, H100 bring-up).  Elsewhere the XLA
    step.  Grid-path deposits: XLA's scatter (segment_sum, atomics on a
    GPU) at nx >= 512, where it wins 5-40x; the flat one-hot below, where
    the two are within 12% of each other and the scatter's atomics contend
    on few cells."""
    if (cfg.shape == ParticleShape.MATRIX_FREE
            and jax.default_backend() == "gpu"):
        return DepositMethod.PALLAS
    return DepositMethod.SEGMENT if cfg.nx >= 512 else DepositMethod.ONEHOT


class Stepper:
    """Precompiled step functions for a fixed Config.

    `axis_name` makes every grid reduction finish with a psum over that mesh
    axis — set when the particle axis is sharded under shard_map
    (parallel/mesh.py); None on a single device.  This is the analogue of
    the reference's deposit-then-MPI_Allreduce pattern
    (src/pic1dp_interaction.F90:130-135): each device deposits its particle
    shard and the partial sums are reduced over NCCL.
    """

    def __init__(self, cfg: Config, axis_name: str | None = None,
                 interpret: bool = False):
        """`interpret=True` runs the fused Pallas step (deposit_method
        PALLAS) in the Pallas interpreter, which is how it is tested off the
        GPU; it is never chosen implicitly."""
        cfg.validate()
        self.cfg = cfg
        self.axis_name = axis_name
        self.interpret = interpret
        self._fused = None  # lazily built FusedStepper (pallas path)
        self.deposit_method = cfg.deposit_method
        if self.deposit_method == DepositMethod.AUTO:
            self.deposit_method = _auto_method(cfg)
        self.gather_method = (
            "twolevel" if self.deposit_method == DepositMethod.TWOLEVEL
            else "take")
        self.dtype = jnp.dtype(cfg.dtype)
        if cfg.bf16_weights and cfg.nspecies > 1 and any(
                abs(s.v0) > 2.0 * (s.temperature / s.mass) ** 0.5
                for s in cfg.species):
            # measured limitation (docs/performance.md): the bf16 w1
            # rounding destabilizes the post-saturation vortex
            # reorganization of strongly shifted multi-species equilibria
            # (deterministic divergence, dt/seed-independent; f32 and
            # p-only quantization stable).  Single-species composite
            # equilibria representing the same physics are unaffected.
            import warnings

            warnings.warn(
                "bf16_weights with multiple strongly shifted species "
                "(|v0| > 2 vth) has a measured post-saturation divergence "
                "(bf16 w1 rounding amplifies the vortex-merging "
                "transient; docs/performance.md). Use f32, the "
                "equivalent single-species composite equilibrium, or stop "
                "before deep saturation.", RuntimeWarning, stacklevel=3)
        self.spectral = SpectralOperator.create(cfg.nx, cfg.modes, cfg.lx, self.dtype)
        self.sp = dist.SpeciesParams.from_config(cfg, self.dtype)
        self.step = jax.jit(self._step)
        self.initial_field = jax.jit(self._initial_field)
        self.energies = jax.jit(
            lambda s: diagnostics.energies(cfg, self.sp, s, self.axis_name))
        self.ptcldist = jax.jit(
            lambda s: diagnostics.ptcldist(cfg, self.sp, s))
        self.full_rho = jax.jit(
            lambda s: self.deposit_charge(s.x, s.p, s.w, s.live))

    def _psum(self, x):
        if self.axis_name is not None:
            return jax.lax.psum(x, self.axis_name)
        return x

    # ---- pieces ----

    def _gather(self, x, electric):
        """E at particle positions, stacked species.  EXPLICIT shapes apply
        the stored COO S (reference MatMult(S, E),
        src/pic1dp_interaction.F90:213-220); otherwise matrix-free take."""
        cfg = self.cfg
        if cfg.shape == ParticleShape.EXPLICIT:
            s_mat = shape_ops.ShapeMatrix.assemble(x, cfg.lx, cfg.nx)
            return s_mat.gather(electric, method=self.gather_method,
                                chunk=cfg.deposit_chunk)
        flat = gather_ops.gather(
            x.reshape(-1), electric, cfg.lx, cfg.nx,
            method=self.gather_method, chunk=cfg.deposit_chunk,
        )
        return flat.reshape(x.shape)

    def deposit_charge(self, x, p, w, live):
        """Charge density on the grid (reference interaction_collect_charge,
        src/pic1dp_interaction.F90:33-155)."""
        cfg = self.cfg
        val = w if cfg.deltaf else p
        val = jnp.where(live, val, 0.0) * self.sp.charge
        if cfg.shape == ParticleShape.EXPLICIT:
            # per-nx winner, same crossover as the position-path AUTO
            # resolution: flat one-hot below nx=2048, XLA scatter above
            # (docs/performance.md SpMV table)
            coo_method = ("segment"
                          if self.deposit_method == DepositMethod.SEGMENT
                          else "onehot")
            grid = shape_ops.ShapeMatrix.assemble(x, cfg.lx, cfg.nx).deposit(
                val, method=coo_method, chunk=cfg.deposit_chunk)
        else:
            grid = deposit_ops.deposit(
                x.reshape(-1), val.reshape(-1), cfg.lx, cfg.nx,
                method=self.deposit_method.value
                if self.deposit_method in (DepositMethod.SEGMENT,
                                           DepositMethod.TWOLEVEL)
                else "onehot",
                chunk=cfg.deposit_chunk,
            )
        grid = self._psum(grid)
        rho = grid * (cfg.nx / cfg.lx)
        if not cfg.deltaf:
            # subtract equilibrium charge density (reference :142-148)
            rho = rho - jnp.sum(self.sp.charge * self.sp.density)
        return rho

    def _push(self, x, v, p, w, x_bak, v_bak, w_bak, electric, dt_eff):
        """One RK substep particle push: grid-path gather composed with the
        shared update body (_push_math holds the load-bearing ordering)."""
        e_p = self._gather(x, electric)
        return self._push_math(e_p, x, v, p, w, x_bak, v_bak, w_bak, dt_eff)

    def solve_field(self, rho):
        return self.spectral.solve(rho)

    # ---- matrix-free spectral hot path (cfg.shape == MATRIX_FREE) ----
    #
    # The reference's iptclshape=4 recomputes the shape on the fly instead of
    # storing S (src/pic1dp_particle.F90:133-138); the analogue here
    # goes further: the hot loop composes hat interpolation with the partial
    # DFT so no nx-grid is ever touched (see ops/spectral.py).  The grid path
    # below (_step_grid) is the explicit-S analogue and the cross-check.

    def _deposit_val(self, p, w, live):
        """Per-particle deposit value with charge and live mask folded in."""
        val = w if self.cfg.deltaf else p
        return jnp.where(live, val, 0.0) * self.sp.charge

    def _trig(self, x):
        return spectral_ops.mode_trig(x, self.cfg.lx, self.cfg.nx, self.cfg.modes)

    def _project_and_solve(self, trig, p, w, live):
        """Deposit in mode space + field solve; returns (mode_re, mode_im)
        of E.  The psum is the reference's deposition MPI_Allreduce."""
        p_c, p_s = spectral_ops.project_modes(trig, self._deposit_val(p, w, live))
        p_c, p_s = self._psum((p_c, p_s))
        return spectral_ops.solve_modes_from_projections(
            p_c, p_s, self.spectral.grad_inv, self.cfg.lx), (p_c, p_s)

    def _push_math(self, e_p, x, v, p, w, x_bak, v_bak, w_bak, dt_eff):
        """The push update given the gathered field (same ordering as _push)."""
        cfg = self.cfg
        sp = self.sp
        q_over_m = sp.charge / sp.mass
        x_new = wrap_x(x_bak + dt_eff * v, cfg.lx)
        if cfg.deltaf:
            drive = (p * e_p) if cfg.linear else ((p - w) * e_p)
            kern = dist.minus_dlnf0_dv(cfg.equilibrium, sp, v)
            w_new = w_bak + dt_eff * drive * kern * q_over_m
        else:
            w_new = w
        v_new = v if cfg.linear else v_bak + dt_eff * e_p * q_over_m
        return x_new, v_new, w_new

    def _quantize_w1(self, w1):
        """With cfg.bf16_weights the midpoint weights enter the substep-2
        drive rounded to bfloat16 (the fused kernel's arithmetic too); the
        midpoint projections keep the full-precision w1."""
        if self.cfg.bf16_weights:
            return w1.astype(jnp.bfloat16).astype(w1.dtype)
        return w1

    def _spectral_pushes(self, state: SimState):
        """Both RK substep pushes of the matrix-free step: the trig at the
        substep-1 deposit positions is reused for the substep-2 gather.
        Returns the pushed (x2, v2, w2), the midpoint modes and the raw
        midpoint projections."""
        cfg = self.cfg
        dt = jnp.asarray(cfg.dt, self.dtype)
        x0, v0, w0 = state.x, state.v, state.w
        p, live = state.p, state.live

        # substep 1: gather at x0 from the step-start field, half push
        t0 = self._trig(x0)
        e_p0 = spectral_ops.efield_at(t0, state.mode_re, state.mode_im)
        x1, v1, w1 = self._push_math(e_p0, x0, v0, p, w0, x0, v0, w0, 0.5 * dt)
        t1 = self._trig(x1)
        (mre1, mim1), proj1 = self._project_and_solve(t1, p, w1, live)

        # substep 2: gather at x1 from the midpoint field (trig reused)
        e_p1 = spectral_ops.efield_at(t1, mre1, mim1)
        x2, v2, w2 = self._push_math(e_p1, x1, v1, p, self._quantize_w1(w1),
                                     x0, v0, w0, dt)
        return (x2, v2, w2), (mre1, mim1), proj1

    def _step_spectral(self, state: SimState) -> SimState:
        """One RK2 step, matrix-free, in plain XLA."""
        (x2, v2, w2), _, _ = self._spectral_pushes(state)
        t2 = self._trig(x2)
        (mre2, mim2), (p_c, p_s) = self._project_and_solve(
            t2, state.p, w2, state.live)
        return self._finish(state, x2, v2, w2, mre2, mim2, p_c, p_s)

    def _finish(self, state, x2, v2, w2, mre2, mim2, p_c, p_s) -> SimState:
        electric = self.spectral.e_grid(mre2, mim2)
        rho = self.spectral.rho_grid_from_projections(p_c, p_s, self.cfg.lx)
        return SimState(x=x2, v=v2, p=state.p, w=w2, live=state.live,
                        rho=rho, electric=electric, mode_re=mre2, mode_im=mim2)

    # ---- jitted entry points ----

    def _initial_field(self, state: SimState) -> SimState:
        """Deposit + solve for the freshly loaded state
        (reference src/pic1dp.F90:70-72)."""
        if self.cfg.shape == ParticleShape.MATRIX_FREE:
            trig = self._trig(state.x)
            (mre, mim), (p_c, p_s) = self._project_and_solve(
                trig, state.p, state.w, state.live)
            electric = self.spectral.e_grid(mre, mim)
            rho = self.spectral.rho_grid_from_projections(p_c, p_s, self.cfg.lx)
        else:
            rho = self.deposit_charge(state.x, state.p, state.w, state.live)
            electric, mre, mim = self.solve_field(rho)
        return SimState(x=state.x, v=state.v, p=state.p, w=state.w,
                        live=state.live, rho=rho, electric=electric,
                        mode_re=mre, mode_im=mim)

    def _step(self, state: SimState) -> SimState:
        """One full RK2 step (two substeps), no particle optimization."""
        if self.cfg.shape == ParticleShape.MATRIX_FREE:
            if self.deposit_method == DepositMethod.PALLAS:
                return self._step_spectral_pallas(state)
            return self._step_spectral(state)
        return self._step_grid(state)

    def _get_fused(self):
        from pic1dp_tpu.ops.pallas_kernels import FusedStepper

        if self._fused is None:
            self._fused = FusedStepper(self.cfg, interpret=self.interpret,
                                       axis_name=self.axis_name)
        return self._fused

    def _step_spectral_pallas(self, state: SimState) -> SimState:
        """Matrix-free RK2 step with both substeps as fused Pallas kernels
        (ops/pallas_kernels.py); the mode solve between them is scalar
        work."""
        fused = self._get_fused()
        cfg = self.cfg
        x0, v0, p, w0 = state.x, state.v, state.p, state.w
        pc1, ps1 = self._psum(fused.substep1(
            x0, v0, p, w0, state.mode_re, state.mode_im))
        mre1, mim1 = spectral_ops.solve_modes_from_projections(
            pc1, ps1, self.spectral.grad_inv, cfg.lx)
        x2, v2, w2, (pc2, ps2) = fused.substep2(
            x0, v0, p, w0, state.mode_re, state.mode_im, mre1, mim1)
        pc2, ps2 = self._psum((pc2, ps2))
        mre2, mim2 = spectral_ops.solve_modes_from_projections(
            pc2, ps2, self.spectral.grad_inv, cfg.lx)
        return self._finish(state, x2, v2, w2, mre2, mim2, pc2, ps2)

    def _step_grid(self, state: SimState) -> SimState:
        """Grid-histogram RK2 step (explicit-shape analogue, cross-check
        path for iptclshape 1-3, reference src/pic1dp_particle.F90:275-350)."""
        cfg = self.cfg
        dt = jnp.asarray(cfg.dt, self.dtype)
        x0, v0, w0 = state.x, state.v, state.w
        p, live = state.p, state.live

        # substep 1: half step from (x0, v0, w0)
        x1, v1, w1 = self._push(x0, v0, p, w0, x0, v0, w0, state.electric, 0.5 * dt)
        rho1 = self.deposit_charge(x1, p, w1, live)
        e1, _, _ = self.solve_field(rho1)

        # substep 2: full step from the same backups, midpoint quantities
        x2, v2, w2 = self._push(x1, v1, p, w1, x0, v0, w0, e1, dt)
        rho2 = self.deposit_charge(x2, p, w2, live)
        e2, mre, mim = self.solve_field(rho2)

        return SimState(x=x2, v=v2, p=p, w=w2, live=live,
                        rho=rho2, electric=e2, mode_re=mre, mode_im=mim)

    def multi_step_body(self, state: SimState, k: int) -> SimState:
        """k-step advance via lax.scan — the traced body shared by
        make_multi_step (single device) and ShardedStepper.make_multi_step
        (called inside shard_map on the per-device shards)."""
        def body(state, _):
            return self._step(state), None

        out, _ = jax.lax.scan(body, state, None, length=k)
        return out

    def make_multi_step(self, k: int):
        """Jitted k-step advance: one dispatch, one compiled loop —
        amortizes host->device launch latency (the reference's analogue is
        simply its Fortran time loop, src/pic1dp.F90:78-109)."""
        return jax.jit(functools.partial(self.multi_step_body, k=k))

    def push_pair(self, state: SimState):
        """Both RK substeps' pushes WITHOUT the final deposit/solve; used by
        the optimization path, which runs merge/remove/split after the second
        push and before the final charge collection (reference
        src/pic1dp.F90:79-90 with particle_optimize acting on irk == 2).

        Returns the state after substep 2's push with stale field quantities.
        """
        cfg = self.cfg
        if cfg.shape == ParticleShape.MATRIX_FREE:
            (x2, v2, w2), (mre1, mim1), (p_c, p_s) = \
                self._spectral_pushes(state)
            rho1 = self.spectral.rho_grid_from_projections(p_c, p_s, cfg.lx)
            e1 = self.spectral.e_grid(mre1, mim1)
        else:
            dt = jnp.asarray(cfg.dt, self.dtype)
            x0, v0, w0 = state.x, state.v, state.w
            p, live = state.p, state.live
            x1, v1, w1 = self._push(x0, v0, p, w0, x0, v0, w0, state.electric, 0.5 * dt)
            rho1 = self.deposit_charge(x1, p, w1, live)
            e1, _, _ = self.solve_field(rho1)
            x2, v2, w2 = self._push(x1, v1, p, w1, x0, v0, w0, e1, dt)
        return SimState(x=x2, v=v2, p=state.p, w=w2, live=state.live,
                        rho=rho1, electric=e1, mode_re=state.mode_re,
                        mode_im=state.mode_im)

    def collect_and_solve(self, state: SimState) -> SimState:
        """Final deposit + solve after optimization."""
        return self._initial_field(state)

    def apply_optimizations(self, state: SimState, key, merge=None,
                            remove=None, split=None) -> SimState:
        from pic1dp_tpu.core import optimize as opt_mod

        return opt_mod.apply_optimizations(
            self.cfg, self.sp, state, key, merge=merge, remove=remove,
            split=split, axis_name=self.axis_name)
