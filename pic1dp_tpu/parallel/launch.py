"""Multi-process launch utilities.

The reference launches with `mpiexec -n NPE_RUN ./pic1dp` over MPI
(reference run/Makefile:38-48, Makefile:38-39).  The JAX equivalent is one
process per host (or per GPU): every process runs the same program,
`jax.distributed.initialize` connects them, and the global device mesh
spans every GPU of the job.  The particle axis is sharded over all devices;
XLA hands the collectives to NCCL (NVLink within a host, the network across
hosts).  The per-step collectives are the (2, nmode)-scalar mode-projection
psums, a few hundred bytes, so weak scaling holds by construction.

Typical multi-process entry point:

    from pic1dp_tpu.parallel import launch
    launch.initialize("host0:1234", num_processes=2, process_id=rank)
    sim = Simulation(cfg, mesh=launch.global_mesh(), out_path="run")
    sim.run()                                # only process 0 writes output
"""

from __future__ import annotations

import jax

from pic1dp_tpu.parallel.mesh import Mesh, make_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed.initialize with explicit arguments.  Called with
    none, it relies on JAX's own cluster detection (SLURM, Open MPI and
    the other environments JAX recognizes), which raises if it finds no
    cluster."""
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh() -> Mesh:
    """1-D particle-parallel mesh over every device in the job (all hosts)."""
    return make_mesh(devices=jax.devices())


def is_io_process() -> bool:
    return jax.process_index() == 0
