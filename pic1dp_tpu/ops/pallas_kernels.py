"""Fused gather->push->deposit kernels for the matrix-free RK2 step, written
in Pallas for the Triton route (`backend="triton"`).

The matrix-free spectral formulation (ops/spectral.py) makes a substep pure
elementwise work plus a few global sums, but the trig/hat-weight
intermediates of substep 1 are needed on both sides of the mode solve, and
XLA cannot fuse across that reduction.  These two kernels move only the
particle streams:

    kernel 1:  read x0, v0, p, w0      -> per-block partial projections at x1
    kernel 2:  read x0, v0, p, w0      -> write x2, v2, w2 (in place)
                                          + per-block partial projections at x2

Kernel 2 recomputes the midpoint state (x1, v1, w1) from the step-start
streams instead of reading it back: 11 N floats per step, the floor of the
nonlinear delta-f RK2 step.  The update ordering is the reference's (x, then
w with the analytic -f0'/f0, then v; src/pic1dp_interaction.F90:238-339).

Each program handles one power-of-two block of one species' markers, with
a mask on the tail, so the capacity needs no alignment.  Blocks run in any
order: each writes its own (2 * nmode) partial sums, which XLA adds up
outside the kernel together with the mode solve and the psum of a sharded
run.  Species constants are selected by the block's species index.  Dead
markers carry p = w = 0 (core/state.py), so no live mask is streamed.

Static configuration (lx, nx, modes, dt, equilibrium, species) is baked into
the kernel closure.  A Pallas kernel runs on the CPU only in interpret mode,
and only when the caller asks for it with `interpret=True`.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from pic1dp_tpu.config import Config

BLOCK = 1024     # markers per program (a power of two)
NUM_WARPS = 4


def _make_sel(sid, ns: int):
    """Per-species constant selector.

    `sid` is the species index of the block's markers (a traced vector;
    None when ns == 1).  sel(vals) returns vals[sid]: a plain python float whenever
    every species shares the value (always for ns == 1), else a chain of
    ns - 1 scalar selects."""
    def sel(vals):
        vals = [float(v) for v in vals]
        if all(v == vals[0] for v in vals):
            return vals[0]
        acc = vals[-1]
        for s in range(ns - 2, -1, -1):
            acc = jnp.where(sid == s, vals[s], acc)
        return acc
    return sel


def _fast_wrap(x, lx: float):
    """Periodic wrap via x - lx*floor(x/lx) with a static reciprocal.  The
    reciprocal rounding can land 1 ulp outside [0, lx); the selects fix
    it."""
    y = x - lx * jnp.floor(x * (1.0 / lx))
    return jnp.where(y >= lx, y - lx, jnp.where(y < 0.0, y + lx, y))


# exp-argument clamp for the ratio forms below: exp(60) ~ 1.1e26 stays finite
# in f32 and the clamped branch only engages where one Gaussian component is
# < e-60 of the other (its contribution is below f32 resolution anyway).
_EXP_CLAMP = 60.0


def _minus_dlnf0_dv_fast(eq, cfg: Config, sel, v):
    """distributions.minus_dlnf0_dv with species parameters folded host-side
    and the two-Gaussian equilibria rewritten in single-exponential ratio
    form:

        (a e^A + b e^B) / (e^A + e^B)  =  (a + b r) / (1 + r),  r = e^(B-A)

    — one transcendental per marker instead of two.  Mathematically identical
    to the distributions.py forms; bitwise-equal for MAXWELLIAN and
    TWO_STREAM1.

    Per-species parameters go through `sel` (_make_sel).  Degenerate
    bump-on-tail core fractions (density exactly 0 or 1) keep their exact
    single-Maxwellian forms when EVERY species is degenerate the same way; a
    mixed multi-species set instead clamps that species' log_ratio to
    +-1e4, which the +-_EXP_CLAMP clip turns into r = e^-+60 — a relative
    deviation < 1e-25, far below the 1e-12 equivalence pins."""
    from pic1dp_tpu.config import Equilibrium

    sps = cfg.species
    vth2 = [sp.temperature / sp.mass for sp in sps]
    inv_vth2 = [1.0 / t for t in vth2]
    if eq == Equilibrium.MAXWELLIAN:
        return (v - sel([sp.v0 for sp in sps])) * sel(inv_vth2)
    if eq == Equilibrium.TWO_STREAM1:
        return v - 2.0 / v
    if eq == Equilibrium.TWO_STREAM2:
        # r = em/ep = exp(((v+v0)^2 - (v-v0)^2)/(2 vth2)) = exp(2 v v0/vth2)
        r = jnp.exp(jnp.clip(
            v * sel([2.0 * sp.v0 * iv for sp, iv in zip(sps, inv_vth2)]),
            -_EXP_CLAMP, _EXP_CLAMP))
        v0 = sel([sp.v0 for sp in sps])
        iv = sel(inv_vth2)
        return ((v + v0) + (v - v0) * r) * iv / (1.0 + r)
    if eq == Equilibrium.BUMP_ON_TAIL:
        vth2b = [sp.temperature2 / sp.mass for sp in sps]
        c_core = [sp.density / math.sqrt(t) for sp, t in zip(sps, vth2)]
        c_beam = [(1.0 - sp.density) / math.sqrt(tb) if tb > 0.0 else 0.0
                  for sp, tb in zip(sps, vth2b)]
        if all(cb <= 0.0 for cb in c_beam):
            return v * sel(inv_vth2)
        if all(cc <= 0.0 for cc in c_core):
            return (v - sel([sp.v0 for sp in sps])) * sel(
                [1.0 / tb for tb in vth2b])
        # r = beam/core = (c_beam/c_core) exp(v^2/(2 vth2) - (v-v0)^2/(2 vth2b))
        # degenerate species in a mixed set: sanitize the dead component's
        # width to the live one's (keeps arg finite at v = v0) and clamp
        # log_ratio so the clip drives r to e^-+_EXP_CLAMP
        safe_iv = [iv if cc > 0.0 else 1.0 / tb
                   for iv, cc, tb in zip(inv_vth2, c_core, vth2b)]
        safe_ivb = [1.0 / tb if cb > 0.0 else iv
                    for iv, cb, tb in zip(safe_iv, c_beam, vth2b)]
        log_ratio = [math.log(cb) - math.log(cc) if (cb > 0.0 and cc > 0.0)
                     else (-1e4 if cb <= 0.0 else 1e4)
                     for cb, cc in zip(c_beam, c_core)]
        v0 = sel([sp.v0 for sp in sps])
        iv = sel(safe_iv)
        ivb = sel(safe_ivb)
        arg = (v * v * sel([0.5 * x for x in safe_iv])
               - (v - v0) ** 2 * sel([0.5 * x for x in safe_ivb])
               + sel(log_ratio))
        r = jnp.exp(jnp.clip(arg, -_EXP_CLAMP, _EXP_CLAMP))
        return (v * iv + r * ((v - v0) * ivb)) / (1.0 + r)
    raise ValueError(f"unknown equilibrium {eq}")


def _hat_trig(x, lx: float, nx: int, modes, cos_ref, sin_ref):
    """Hat-interpolated (C_m, S_m) per kept mode at positions x — the only
    trig quantities the kernels use (E gather: C*mre - S*mim; deposit
    projections: val*C, val*S):

        C = w0 cos(th0) + w1 cos(th1) = c0 (1 + w1 (cd - 1)) - s0 (w1 sd)

    with th0 = 2 pi m ix0 / nx the integer grid angle of the left
    neighbour.  c0 and s0 are gathered from the (nx,) cos/sin tables of
    the grid angles at (m * ix0) mod nx: a few KB that stay in L1, faster
    on the H100 than libdevice sinf/cosf and than a quadrant polynomial
    (PERF.md, H100 bring-up)."""
    dtype = x.dtype
    s = x * (nx / lx)
    ix0 = jnp.floor(s)
    w1 = s - ix0
    # x is wrapped into [0, lx), so s >= 0; the guard catches the half-ulp
    # case where x just below lx rounds s up to exactly nx
    ix0 = jnp.minimum(ix0, float(nx - 1)).astype(jnp.int32)
    out = []
    for m in modes:
        j = (ix0 * np.int32(m)) % np.int32(nx)
        c0 = plgpu.load(cos_ref.at[j])
        s0 = plgpu.load(sin_ref.at[j])
        step = 2.0 * np.pi * m / nx
        cdm1 = np.asarray(np.cos(step) - 1.0, dtype)  # typed: np.float64
        sd = np.asarray(np.sin(step), dtype)          # scalars would promote
        a = 1.0 + w1 * cdm1
        b = w1 * sd
        out.append((c0 * a - s0 * b, s0 * a + c0 * b))
    return out


def make_substep_call(cfg: Config, substep: int, n: int, *,
                      interpret: bool = False, axis_name: str | None = None):
    """Build one fused substep kernel for all species.

    Particle arrays are the (ns, n) state (n = per-species, per-shard
    length).  Returns fn:

        substep 1:  fn(x0, v0, p, w0, mre0, mim0) -> proj1
        substep 2:  fn(x0, v0, p, w0, mre0, mim0, mre1, mim1)
                      -> (x2, v2, w2, proj2)

    proj is the (2, nmode) raw mode projections (spectral.project_modes
    semantics: row 0 cos, row 1 sin) of the charge-weighted deposit at the
    pushed positions, summed over species.  Frozen streams (v in linear
    mode, w in full-f) are returned as given.  With cfg.bf16_weights the
    midpoint weights w1 are rounded to bfloat16 before the substep-2 drive,
    exactly as the XLA step does; the midpoint projections use the
    full-precision w1."""
    if substep not in (1, 2):
        raise ValueError(f"substep must be 1 or 2, got {substep}")
    dtype = jnp.dtype(cfg.dtype)
    quantize_w1 = cfg.bf16_weights
    ns = cfg.nspecies
    nb = pl.cdiv(n, BLOCK)
    nmode = len(cfg.modes)
    lx, nx, modes = cfg.lx, cfg.nx, cfg.modes
    vma = frozenset() if axis_name is None else frozenset({axis_name})
    dt_half = 0.5 * cfg.dt
    charges = [sp.charge for sp in cfg.species]
    dtqm_half_l = [dt_half * (sp.charge / sp.mass) for sp in cfg.species]
    dtqm_full_l = [cfg.dt * (sp.charge / sp.mass) for sp in cfg.species]
    has_v = not cfg.linear     # v stream updated
    has_w = cfg.deltaf         # w stream updated
    n_modes_in = 2 if substep == 1 else 4
    n_out = 0 if substep == 1 else 1 + has_v + has_w

    def kernel(*refs):
        x_ref, v_ref, p_ref, w_ref = refs[:4]
        scal = refs[4:4 + n_modes_in]
        cos_ref, sin_ref = refs[4 + n_modes_in:6 + n_modes_in]
        out_refs = refs[len(refs) - n_out - 1:len(refs) - 1]
        proj_ref = refs[-1]
        pid = pl.program_id(0)
        sid = pid // nb if ns > 1 else None
        loc = (pid % nb) * BLOCK + jnp.arange(BLOCK, dtype=jnp.int32)
        mask = loc < n
        off = loc if ns == 1 else sid * n + loc
        # species selects act on a per-marker vector of the species index:
        # Triton lowers a select with a scalar predicate incorrectly
        sel = _make_sel(None if ns == 1 else off // n, ns)

        def load(ref):
            return plgpu.load(ref.at[off], mask=mask, other=0.0).astype(dtype)

        def hat_trig(x):
            return _hat_trig(x, lx, nx, modes, cos_ref, sin_ref)

        def gather_e(cs, mre_ref, mim_ref):
            e = None
            for i, (c_m, s_m) in enumerate(cs):
                term = c_m * mre_ref[i] - s_m * mim_ref[i]
                e = term if e is None else e + term
            return 2.0 * e

        def kern(v):
            return _minus_dlnf0_dv_fast(cfg.equilibrium, cfg, sel, v)

        x0, v0, p, w0 = load(x_ref), load(v_ref), load(p_ref), load(w_ref)
        dtqm_h = sel(dtqm_half_l)
        # substep 1 (both kernels): half push from the step-start field.
        # Kernel 1 needs the field at x0 only for w1; kernel 2 for v1 and,
        # when nonlinear, for the w1 in its drive term
        need_w1 = has_w and (substep == 1 or not cfg.linear)
        need_e0 = need_w1 or (substep == 2 and has_v)
        x1 = _fast_wrap(x0 + dt_half * v0, lx)
        e0 = gather_e(hat_trig(x0), scal[0], scal[1]) if need_e0 else None
        if need_w1:
            drive0 = (p * e0) if cfg.linear else ((p - w0) * e0)
            w1 = w0 + dtqm_h * drive0 * kern(v0)
        else:
            w1 = w0
        if substep == 1:
            x_new, val_w = x1, w1
        else:
            cs1 = hat_trig(x1)
            e1 = gather_e(cs1, scal[2], scal[3])
            if quantize_w1 and has_w and not cfg.linear:
                w1 = w1.astype(jnp.bfloat16).astype(dtype)
            dtqm_f = sel(dtqm_full_l)
            v1 = v0 + dtqm_h * e0 if has_v else v0
            x_new = _fast_wrap(x0 + cfg.dt * v1, lx)
            if has_w:
                drive1 = (p * e1) if cfg.linear else ((p - w1) * e1)
                val_w = w0 + dtqm_f * drive1 * kern(v1)
            else:
                val_w = w0
            outs = [x_new] + ([v0 + dtqm_f * e1] if has_v else []) \
                + ([val_w] if has_w else [])
            for ref, o in zip(out_refs, outs):
                plgpu.store(ref.at[off], o.astype(ref.dtype), mask=mask)
        val = (val_w if cfg.deltaf else p) * sel(charges)
        val = jnp.where(mask, val, 0.0)
        for i, (c_m, s_m) in enumerate(hat_trig(x_new)):
            plgpu.store(proj_ref.at[pid, np.int32(i)], jnp.sum(val * c_m))
            plgpu.store(proj_ref.at[pid, np.int32(nmode + i)],
                        jnp.sum(val * s_m))

    out_shape = [jax.ShapeDtypeStruct((ns * n,), dtype, vma=vma)] * n_out \
        + [jax.ShapeDtypeStruct((ns * nb, 2 * nmode), dtype, vma=vma)]
    # kernel 2 writes x2/v2/w2 over x0/v0/w0: each block reads its markers
    # before it writes them, and nothing reads the step-start state later
    # (in place measured 1.45x faster than fresh outputs, PERF.md)
    aliases = {}
    if substep == 2:
        aliases = {0: 0}
        if has_v:
            aliases[1] = 1
        if has_w:
            aliases[3] = 1 + has_v
    call = pl.pallas_call(
        kernel,
        grid=(ns * nb,),
        out_shape=tuple(out_shape),
        input_output_aliases=aliases,
        interpret=interpret,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        name=f"pic1dp_substep{substep}",
    )
    ang = 2.0 * np.pi * np.arange(nx) / nx
    tables = (np.cos(ang).astype(dtype), np.sin(ang).astype(dtype))

    def fn(*arrays):
        particle, mode_scal = arrays[:4], arrays[4:]
        shape = particle[0].shape
        flat = [a.reshape(-1) for a in particle]
        scal = [m.astype(dtype) for m in mode_scal]
        tabs = [jnp.asarray(t) for t in tables]
        if axis_name is not None:
            # replicated inputs -> varying, so every kernel input carries
            # the same manual-axes set under shard_map
            scal = [jax.lax.pcast(m, axis_name, to="varying") for m in scal]
            tabs = [jax.lax.pcast(t, axis_name, to="varying") for t in tabs]
        *pouts, part = call(*flat, *scal, *tabs)
        proj = jnp.sum(part, axis=0).reshape(2, nmode)
        if substep == 1:
            return proj
        pouts = iter(o.reshape(shape) for o in pouts)
        x2 = next(pouts)
        v2 = next(pouts) if has_v else particle[1]
        w2 = next(pouts) if has_w else particle[3]
        return x2, v2, w2, proj

    return fn


class FusedStepper:
    """Per-config factory of the two fused substep callables, used by
    core.step.Stepper when the deposit method is PALLAS.  Kernels are built
    lazily per particle-array length: under shard_map the per-device shard
    length is what reaches the kernel, not the global capacity.

    The kernels compile for a GPU through Triton.  On any other backend they
    run only in the Pallas interpreter, and only if `interpret=True`."""

    def __init__(self, cfg: Config, interpret: bool = False,
                 axis_name: str | None = None):
        if not interpret and jax.default_backend() != "gpu":
            raise ValueError(
                "the fused Pallas step compiles only for a GPU (Triton); "
                f"this backend is {jax.default_backend()!r}. Pass "
                "interpret=True to run it in the Pallas interpreter, or use "
                "the XLA step (deposit_method AUTO).")
        self.cfg = cfg
        self.interpret = interpret
        self.axis_name = axis_name
        self._subs: dict = {}

    def _sub(self, substep: int, n: int):
        key = (substep, n)
        if key not in self._subs:
            self._subs[key] = make_substep_call(
                self.cfg, substep, n, interpret=self.interpret,
                axis_name=self.axis_name)
        return self._subs[key]

    def substep1(self, x, v, p, w, mode_re, mode_im):
        """(ns, N) step-start state + step-start modes -> (p_c, p_s), the
        raw projections of the midpoint deposit."""
        proj = self._sub(1, x.shape[-1])(x, v, p, w, mode_re, mode_im)
        return proj[0], proj[1]

    def substep2(self, x, v, p, w, mode_re0, mode_im0, mode_re1, mode_im1):
        """Step-start state + step-start and midpoint modes
        -> (x2, v2, w2, (p_c, p_s))."""
        x2, v2, w2, proj = self._sub(2, x.shape[-1])(
            x, v, p, w, mode_re0, mode_im0, mode_re1, mode_im1)
        return x2, v2, w2, (proj[0], proj[1])

