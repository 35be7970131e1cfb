"""Marker particle loading.

Mirrors reference particle_load (src/pic1dp_particle.F90:145-269):
  1. velocities: Gaussian ~ f0 for PHYSICAL marker loading (Maxwellian only,
     :172-178) or uniform in [-v_max, v_max] for UNIFORM loading (:179-181)
  2. equilibrium weight p = f0/g evaluated per equilibrium (:182-218)
  3. x ~ U[0, lx)  (:221-223)
  4. w = sum_modes (A_cos cos(2 pi m x / lx) + A_sin sin(...)) * p
         * pertb_shape(v)  (:225-237)
  5. surplus markers beyond nparticle_init unloaded (live mask) (:239-248)
  6. nonlinear: p += w so p = f/g (:259-264)

Two RNG backends:
  * "jax": counter-based jax.random streams, decorrelated across shards by
    construction (the default).
  * "multirand": bit-exact reproduction of the reference's multirand engines
    (pic1dp_tpu.rng.multirand), drawing in the same order as the reference so
    a constant-seed run loads the identical markers.
"""

from __future__ import annotations

from typing import Callable

import functools

import jax
import jax.numpy as jnp
import numpy as np

from pic1dp_tpu import distributions as dist
from pic1dp_tpu.config import Config, MarkerLoading
from pic1dp_tpu.core.state import SimState, balanced_live_mask
from pic1dp_tpu.ops.spectral import SpectralOperator

PertbShape = Callable[[jnp.ndarray, int], jnp.ndarray]


def _initial_w(cfg: Config, x, p, v, pertb_shape: PertbShape | None):
    """Initial perturbed weight (reference src/pic1dp_particle.F90:225-237)."""
    w = jnp.zeros_like(x)
    for mode, amp_c, amp_s in zip(cfg.init_modes, cfg.init_amp_cos, cfg.init_amp_sin):
        theta = (2.0 * jnp.pi / cfg.lx) * mode * x
        w = w + amp_c * jnp.cos(theta) + amp_s * jnp.sin(theta)
    w = w * p
    if pertb_shape is not None:
        # per-species hook (reference input_pertb_shape, src/pic1dp_input.F90:263-281)
        w = w * jnp.stack([pertb_shape(v[s], s) for s in range(cfg.nspecies)])
    return w


def _reference_live_mask(nmax: int, ninit: int, offsets) -> jnp.ndarray:
    """The reference's unload semantics (src/pic1dp_particle.F90:239-248):
    each rank drops the LAST (nmax - ninit)/npe slots of its block, with the
    division remainder dropped on rank 0 additionally."""
    npe = len(offsets) - 1
    surplus = nmax - ninit
    base = surplus // npe
    mask = np.ones(nmax, dtype=bool)
    for r in range(npe):
        unload = base + (surplus % npe if r == 0 else 0)
        if unload:
            mask[offsets[r + 1] - unload:offsets[r + 1]] = False
    return jnp.asarray(mask)


def _finish_load(cfg: Config, x, v, p, w, live=None) -> SimState:
    state = SimState.zeros(cfg)
    if live is None:
        live = jnp.stack([balanced_live_mask(cfg.nparticle_max, n)
                          for n in cfg.nparticle_init])
    if not cfg.linear:
        # nonlinear: p = f/g = f0/g + delta f/g (reference :259-264)
        p = p + w
    # Dead-slot invariant: p = w = 0 off the live mask, so dead markers
    # deposit nothing and their weights stay zero under the push equations —
    # the hot kernels never need to read the mask (core/state.py docstring).
    # p is stored at cfg.p_dtype (bfloat16 under cfg.bf16_weights); w and the
    # initial-perturbation product above are always computed from the full-
    # precision p first.
    p = jnp.where(live, p, 0.0).astype(jnp.dtype(cfg.p_dtype))
    w = jnp.where(live, w, 0.0)
    state = SimState(
        x=x, v=v, p=p, w=w, live=live,
        rho=state.rho, electric=state.electric,
        mode_re=state.mode_re, mode_im=state.mode_im,
    )
    return state


@functools.partial(jax.jit, static_argnums=(0, 2))
def load_particles_jax(cfg: Config, key: jax.Array,
                       pertb_shape: PertbShape | None = None) -> SimState:
    """Load markers with jax.random (counter-based, shard-friendly).

    Jitted as ONE computation (cfg and the pertb hook are static): without
    this, the eager op-by-op dispatch dominates startup on remote-compile
    backends."""
    dtype = jnp.dtype(cfg.dtype)
    ns, n = cfg.nspecies, cfg.nparticle_max
    sp = dist.SpeciesParams.from_config(cfg, dtype)
    npinit = jnp.asarray([[ni] for ni in cfg.nparticle_init], dtype)

    kv, kx = jax.random.split(key)
    if cfg.marker == MarkerLoading.PHYSICAL:
        # markers ~ f0: Maxwellian only (reference :172-178)
        v = jax.random.normal(kv, (ns, n), dtype) * jnp.sqrt(
            sp.temperature / sp.mass
        ) + sp.v0
        p = sp.density * cfg.lx / npinit * jnp.ones((ns, n), dtype)
    else:
        v = (jax.random.uniform(kv, (ns, n), dtype) - 0.5) * (2.0 * cfg.v_max)
        p = dist.loader_weight_uniform(cfg.equilibrium, sp, v, cfg.lx, cfg.v_max, npinit)

    x = jax.random.uniform(kx, (ns, n), dtype) * cfg.lx
    w = _initial_w(cfg, x, p, v, pertb_shape)
    return _finish_load(cfg, x, v, p, w)


def load_particles_multirand(cfg: Config, emulate_ranks: int = 1,
                             pertb_shape: PertbShape | None = None) -> SimState:
    """Load markers with the multirand-compatible engines, drawing in the
    reference's order so constant-seed runs are marker-for-marker identical
    to the Fortran code run on `emulate_ranks` MPI ranks.

    Rank r owns the PETSC_DECIDE contiguous block of the particle axis
    (n // npe plus one extra for the first n % npe ranks, matching
    VecSetSizes(PETSC_DECIDE, ...) reference src/pic1dp_particle.F90:89-94),
    and seeds its engine with mype=r (reference :159-160).
    """
    from pic1dp_tpu.rng.native import make_multirand

    dtype = jnp.dtype(cfg.dtype)
    ns, n = cfg.nspecies, cfg.nparticle_max
    rc = cfg.rng

    # PETSC_DECIDE ownership blocks
    base, extra = divmod(n, emulate_ranks)
    counts = [base + (1 if r < extra else 0) for r in range(emulate_ranks)]
    offsets = np.concatenate([[0], np.cumsum(counts)])

    x = np.empty((ns, n))
    v = np.empty((ns, n))

    for r in range(emulate_ranks):
        eng = make_multirand(algorithm=rc.algorithm, seed_type=rc.seed_type,
                             mype=r, warmup=rc.warmup,
                             selftest=rc.selftest and r == 0)
        lo, hi = offsets[r], offsets[r + 1]
        cnt = hi - lo
        for s in range(ns):
            # reference order per species: v array, (p computed from v), x array
            if cfg.marker == MarkerLoading.PHYSICAL:
                v[s, lo:hi] = eng.gaussian_array(cnt)
            else:
                v[s, lo:hi] = (eng.real_array(cnt) - 0.5) * 2.0 * cfg.v_max
            x[s, lo:hi] = eng.real_array(cnt) * cfg.lx

    sp = dist.SpeciesParams.from_config(cfg, dtype)
    npinit = jnp.asarray([[ni] for ni in cfg.nparticle_init], dtype)
    vj = jnp.asarray(v, dtype)
    xj = jnp.asarray(x, dtype)
    if cfg.marker == MarkerLoading.PHYSICAL:
        vj = vj * jnp.sqrt(sp.temperature / sp.mass) + sp.v0
        p = sp.density * cfg.lx / npinit * jnp.ones((ns, n), dtype)
    else:
        p = dist.loader_weight_uniform(cfg.equilibrium, sp, vj, cfg.lx, cfg.v_max, npinit)
    w = _initial_w(cfg, xj, p, vj, pertb_shape)
    # reference unload semantics so the LIVE marker set (not just the drawn
    # values) matches a Fortran run on emulate_ranks ranks
    live = jnp.stack([_reference_live_mask(n, ni, offsets)
                      for ni in cfg.nparticle_init])
    return _finish_load(cfg, xj, vj, p, w, live=live)


def load_particles(cfg: Config, key: jax.Array | None = None,
                   pertb_shape: PertbShape | None = None,
                   emulate_ranks: int = 1) -> SimState:
    if cfg.rng.backend == "multirand":
        return load_particles_multirand(cfg, emulate_ranks, pertb_shape)
    if key is None:
        key = jax.random.PRNGKey(cfg.rng.seed)
    return load_particles_jax(cfg, key, pertb_shape)
