"""Device mesh and particle-axis sharding.

The reference's only distributed strategy is particle data-parallelism with a
replicated grid over flat MPI (SURVEY.md section 2.3): each rank owns a
contiguous block of the particle Vecs (src/pic1dp_particle.F90:89-130),
deposits onto a private full grid, and MPI_Allreduces the grid
(src/pic1dp_interaction.F90:130-135); particles never migrate.

The JAX equivalent: a 1-D `jax.sharding.Mesh` over the devices with the
particle axis sharded (PartitionSpec(None, 'p') on the (nspecies, nparticle)
arrays) and every field array replicated.  The whole RK2 step runs under
`shard_map`; the only collectives are the psums closing the charge
deposition and the diagnostic reductions, which XLA hands to NCCL (NVLink
between the GPUs of a host; the network across hosts via the
jax.distributed runtime).  Every GPU reaches every other at the same rate,
so the mesh follows the algorithm alone.

Weak scaling is by construction: per-device work is N_local = N / n_devices
for every phase, and the psum payload is the tiny replicated grid (nx <= 4096
floats).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pic1dp_tpu.config import Config
from pic1dp_tpu.core import diagnostics
from pic1dp_tpu.core.state import SimState
from pic1dp_tpu.core.step import Stepper

AXIS = "p"

try:  # jax >= 0.4.35 exposes shard_map at top level
    from jax import shard_map as _shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _shard_map


def shard_map(f, mesh, in_specs, out_specs):
    # check_vma=False: the varying-manual-axes checker cannot yet type
    # pallas_call bodies replayed by the interpret-mode HLO interpreter
    # (constants come out unvarying); the psum placement is instead validated
    # by the sharded-vs-single equivalence tests in tests/test_parallel.py.
    return _shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                      check_vma=False)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D particle-parallel mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (AXIS,))


def state_specs(sharded: bool = True) -> SimState:
    """PartitionSpec pytree for SimState: particle arrays sharded along the
    particle axis, field arrays replicated."""
    pspec = P(None, AXIS) if sharded else P(None, None)
    rspec = P()
    return SimState(x=pspec, v=pspec, p=pspec, w=pspec, live=pspec,
                    rho=rspec, electric=rspec, mode_re=rspec, mode_im=rspec)


def shard_state(state: SimState, mesh: Mesh) -> SimState:
    """Place a SimState on the mesh with the canonical shardings."""
    specs = state_specs()
    return jax.tree_util.tree_map(
        lambda arr, spec: jax.device_put(arr, NamedSharding(mesh, spec)),
        state, specs)


class ShardedStepper:
    """Stepper whose entry points run under shard_map on a mesh.

    The per-device body is the same Stepper code with axis_name=AXIS, so the
    single-device and multi-device paths share every line of physics.
    """

    def __init__(self, cfg: Config, mesh: Mesh, interpret: bool = False):
        if cfg.nparticle_max % mesh.size:
            raise ValueError(
                f"nparticle_max={cfg.nparticle_max} must be divisible by the "
                f"mesh size {mesh.size}")
        self.cfg = cfg
        self.mesh = mesh
        self.local = Stepper(cfg, axis_name=AXIS, interpret=interpret)
        self.sp = self.local.sp
        specs = state_specs()

        self.step = jax.jit(shard_map(
            self.local._step, mesh, in_specs=(specs,), out_specs=specs))
        self.initial_field = jax.jit(shard_map(
            self.local._initial_field, mesh, in_specs=(specs,), out_specs=specs))
        self.collect_and_solve = jax.jit(shard_map(
            self.local.collect_and_solve, mesh, in_specs=(specs,), out_specs=specs))
        self.push_pair = jax.jit(shard_map(
            self.local.push_pair, mesh, in_specs=(specs,), out_specs=specs))

        def _energies(state):
            return diagnostics.energies(cfg, self.sp, state, axis_name=AXIS)

        self.energies = jax.jit(shard_map(
            _energies, mesh, in_specs=(specs,),
            out_specs=diagnostics.Energies(field=P(), marker=P(), total=P(),
                                           pertb=P())))

        def _ptcldist(state):
            # the psum must happen on the raw histograms inside ptcldist,
            # before normalization / full-f equilibrium subtraction
            return diagnostics.ptcldist(cfg, self.sp, state, axis_name=AXIS)

        dist_out = diagnostics.PtclDist(*([P()] * 6))
        self.ptcldist = jax.jit(shard_map(
            _ptcldist, mesh, in_specs=(specs,), out_specs=dist_out))

        def _full_rho(state):
            return self.local.deposit_charge(state.x, state.p, state.w,
                                             state.live)

        self.full_rho = jax.jit(shard_map(
            _full_rho, mesh, in_specs=(specs,), out_specs=P()))

        self._opt_cache: dict = {}

    def make_multi_step(self, k: int):
        """Jitted k-step lax.scan, the WHOLE scan inside one shard_map (one
        dispatch per output interval, same as Stepper.make_multi_step).
        Inside shard_map the body sees the per-device shards, which is what
        the kernels want."""
        specs = state_specs()
        return jax.jit(shard_map(
            functools.partial(self.local.multi_step_body, k=k),
            self.mesh, in_specs=(specs,), out_specs=specs))

    def apply_optimizations(self, state: SimState, key, merge=None,
                            remove=None, split=None) -> SimState:
        """shard_map-wrapped merge/remove/split; compiled per enabled-op
        pattern (thresholds stay traced)."""
        pattern = (merge is not None, remove is not None, split is not None)
        if pattern not in self._opt_cache:
            specs = state_specs()
            nthresh = sum(pattern)

            def body(state, key, *thresh):
                it = iter(thresh)
                kw = dict(
                    merge=next(it) if pattern[0] else None,
                    remove=next(it) if pattern[1] else None,
                    split=next(it) if pattern[2] else None,
                )
                return self.local.apply_optimizations(state, key, **kw)

            self._opt_cache[pattern] = jax.jit(shard_map(
                body, self.mesh,
                in_specs=(specs, P()) + (P(),) * nthresh,
                out_specs=specs))
        thresh = tuple(t for t in (merge, remove, split) if t is not None)
        return self._opt_cache[pattern](state, key, *thresh)
