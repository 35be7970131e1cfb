"""Bisect the Landau damping-rate error: sampling noise vs systematic bias.

An earlier physics run measured gamma further off theory at 2^22 markers
than pure 1/sqrt(N) noise extrapolated from a 102k-marker point predicts —
so something systematic (dt, grid resolution) or an unlucky seed is in
play.  This sweep runs the k=0.5 Landau case across

  * dt 0.05 -> 0.025     (RK2 discretization bias),
  * nx 64 -> 256         (hat-interpolation / grid shape-factor bias),
  * marker count x seed  (noise scaling + seed scatter),

and prints one JSON line per run.  The WHOLE trajectory runs as one
on-device lax.scan recording per-step field energy — one dispatch + one
(nsteps,) fetch per row, so a slow host (or a slow CPU) costs
per-row seconds, not 200 round trips.  The gamma fit is the same
peaks-of-energy fit the reference's runinfo.py applies, at dt-resolution
sampling.

Usage: python bench/landau_sweep.py [--cpu]
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    cpu = "--cpu" in sys.argv

    import jax

    if cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp
    import numpy as np

    if not cpu:
        from pic1dp_tpu.utils.compile_cache import enable_compilation_cache

        enable_compilation_cache()

    from pic1dp_tpu.analysis.dispersion import Dispersion, species_for_config
    from pic1dp_tpu.config import landau_damping
    from pic1dp_tpu.core.loading import load_particles
    from pic1dp_tpu.core.step import Stepper

    def gamma_for(cfg):
        t0 = time.perf_counter()
        stepper = Stepper(cfg)
        state = stepper.initial_field(
            load_particles(cfg, jax.random.PRNGKey(cfg.rng.seed)))
        nsteps = int(round(cfg.time_max / cfg.dt))

        @jax.jit
        def traj(state):
            def body(s, _):
                s2 = stepper._step(s)
                eng = jnp.sum(s2.electric**2) * (cfg.lx / cfg.nx)
                return s2, eng
            _, e = jax.lax.scan(body, state, None, length=nsteps)
            return e

        e = np.asarray(traj(state))
        wall = time.perf_counter() - t0
        t = (np.arange(nsteps) + 1) * cfg.dt
        pk = [i for i in range(1, len(e) - 1)
              if e[i] > e[i - 1] and e[i] > e[i + 1] and 1.0 <= t[i] <= 15.0]
        return float(np.polyfit(t[pk], np.log(e[pk]), 1)[0] / 2.0), wall

    base = landau_damping(nx=64, nparticle=2**22, k=0.5, amp=1e-4,
                          time_max=20.0, output_interval=0.1,
                          dtype="float64" if cpu else "float32", verbosity=0)
    th = Dispersion(species_for_config(base), 0.5).solve_omega().imag
    print(json.dumps({"theory_gamma": th}), flush=True)

    def run(tag, cfg):
        g, wall = gamma_for(cfg)
        print(json.dumps({
            "tag": tag, "gamma": g, "rel_err": abs(g - th) / abs(th),
            "n": cfg.nparticle_max, "dt": cfg.dt, "nx": cfg.nx,
            "seed": cfg.rng.seed, "wall_s": round(wall, 1)}), flush=True)

    # systematics first (the interesting rows), at 2^22 where sampling
    # noise (~0.3%) sits well below the suspected ~1% bias
    run("base", base)
    run("dt", dataclasses.replace(base, dt=0.025))
    run("nx", dataclasses.replace(base, nx=256))
    run("dt+nx", dataclasses.replace(base, dt=0.025, nx=256))
    # noise scaling + seed scatter
    sizes = (2**20, 2**22) if cpu else (2**20, 2**22, 2**24)
    for n in sizes:
        for seed in (1, 2):
            rng = dataclasses.replace(base.rng, seed=seed)
            run("noise", dataclasses.replace(base, nparticle_max=n, rng=rng))


if __name__ == "__main__":
    main()
