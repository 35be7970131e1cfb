"""pic1dp_tpu — a 1D electrostatic particle-in-cell framework for GPUs.

A from-scratch JAX/XLA/Pallas re-design of the capability surface of
PIC1D-PETSc (reference: /root/reference): delta-f / full-f Vlasov-Poisson
simulation in vector-matrix form, with the particle axis sharded over a
`jax.sharding.Mesh`, a matrix-free spectral hot loop (fused Pallas kernels
on a GPU, plain XLA elsewhere) and a spectral partial-DFT field solve.

Public API:
    Config / SpeciesConfig  — runtime configuration (reference keeps these as
                              compile-time constants in src/pic1dp_input.F90)
    Simulation              — end-to-end driver (reference: src/pic1dp.F90)
    distributions           — equilibrium distribution library
"""

from pic1dp_tpu.config import Config, SpeciesConfig, MarkerLoading, ParticleShape
from pic1dp_tpu.core.state import SimState
from pic1dp_tpu.core.simulation import Simulation

__version__ = "0.1.0"

__all__ = [
    "Config",
    "SpeciesConfig",
    "MarkerLoading",
    "ParticleShape",
    "SimState",
    "Simulation",
]
