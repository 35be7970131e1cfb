"""Simulation state pytree.

The reference holds particle data in PETSc distributed Vecs of fixed length
nparticle_max per species (reference src/pic1dp_particle.F90:34-54) plus a
per-rank live count `particle_np`.  XLA wants static shapes, so the
equivalent is fixed-capacity (nspecies, nparticle_max) arrays with a boolean
`live` mask; merge/remove/split toggle mask bits instead of compacting.

Weight conventions (reference src/pic1dp_particle.F90:28-32):
    p = f / g   (nonlinear)  or  f0 / g  (linear)   — constant along orbits
    w = delta f / g
where f is the total distribution, delta f the perturbation, g the marker
distribution.

The RK2 backups (x_bak/v_bak/w_bak, reference :34-36) are NOT part of the
state: both Runge-Kutta substeps run inside one jitted step, so the backups
are compiler temporaries and never round-trip through HBM between substeps.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from pic1dp_tpu.config import Config


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SimState:
    """All per-run array state.  Shapes:
    x, v, p, w, live: (nspecies, nparticle_max)
    rho, electric:    (nx,)
    mode_re, mode_im: (nmode,)  — E-field Fourier components (the quantities
                      the reference writes to output, src/pic1dp_output.F90:177-181)

    Invariant: p = w = 0 wherever live is False (established by the loader
    and re-established after particle optimization).  Dead markers then
    deposit nothing and their weights stay zero under the push equations, so
    the hot kernels never read the mask; only diagnostics that count markers
    (marker energy/distribution) use `live`.
    """

    x: jnp.ndarray
    v: jnp.ndarray
    p: jnp.ndarray
    w: jnp.ndarray
    live: jnp.ndarray
    rho: jnp.ndarray
    electric: jnp.ndarray
    mode_re: jnp.ndarray
    mode_im: jnp.ndarray

    @property
    def nspecies(self) -> int:
        return self.x.shape[0]

    @property
    def nparticle_max(self) -> int:
        return self.x.shape[1]

    def nparticles(self) -> jnp.ndarray:
        """Live marker count per species (reference particle_np,
        src/pic1dp_particle.F90:54)."""
        return jnp.sum(self.live, axis=1)

    @classmethod
    def zeros(cls, cfg: Config) -> "SimState":
        dtype = jnp.dtype(cfg.dtype)
        ns, n = cfg.nspecies, cfg.nparticle_max
        return cls(
            x=jnp.zeros((ns, n), dtype),
            v=jnp.zeros((ns, n), dtype),
            p=jnp.zeros((ns, n), jnp.dtype(cfg.p_dtype)),
            w=jnp.zeros((ns, n), dtype),
            live=jnp.zeros((ns, n), bool),
            rho=jnp.zeros((cfg.nx,), dtype),
            electric=jnp.zeros((cfg.nx,), dtype),
            mode_re=jnp.zeros((cfg.nmode,), dtype),
            mode_im=jnp.zeros((cfg.nmode,), dtype),
        )


def balanced_live_mask(nparticle_max: int, nparticle_init: int) -> jnp.ndarray:
    """Evenly-spread live mask with exactly nparticle_init True entries.

    The reference "unloads" the surplus (nparticle_max - nparticle_init)
    markers by shrinking each rank's live count (reference
    src/pic1dp_particle.F90:239-248); spreading the dead slots evenly keeps
    every device's work balanced under particle-axis sharding regardless of
    how the array is partitioned.
    """
    import numpy as np

    mask = np.zeros(nparticle_max, dtype=bool)
    # Bresenham spread: exactly nparticle_init evenly spaced indices.
    idx = (np.arange(nparticle_init, dtype=np.int64) * nparticle_max) // nparticle_init
    mask[idx] = True
    return jnp.asarray(mask)
