"""Multi-species perf record.

The fused kernels run ONE pallas_call per substep covering every species:
each block resolves its species' physics constants by a select on the
species index (ops/pallas_kernels.py make_substep_call).  This probe
measures what the species fusion costs:

  A. 1 species x N markers          — the bench.py headline shape;
  B. 2 species x N/2 markers each   — same total markers, same stream bytes.
     B/A per-marker ratio ~1.0 = species fusion is free.

B is a physically meaningful case: the two-stream pair loaded as two
separate Maxwellian SPECIES at v0 = +-3, density 0.5 each (the reference's
nspecies surface, src/pic1dp_input.F90:57-72; same equilibrium as the
single-species two-stream2 composite, so bench/physics.py's two-species row
can pin gamma against the same dispersion root).

Prints one JSON line with per-config pushes/s (two-point scan-slope, robust
per-side minima) and the ratio.  Usage:
    python bench/multispecies.py [n_log2_total=26] [--out FILE]
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    nlog = int(args[0]) if args else 26
    out_path = None
    if "--out" in sys.argv:
        out_path = sys.argv[sys.argv.index("--out") + 1]
    n_total = 2 ** nlog
    steps = int(os.environ.get("PIC1DP_BENCH_STEPS", 10))

    import dataclasses

    import jax
    import numpy as np

    from pic1dp_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()

    from pic1dp_tpu.config import (Equilibrium, SpeciesConfig,
                                   bump_on_tail_default)
    from pic1dp_tpu.core.loading import load_particles
    from pic1dp_tpu.core.step import Stepper

    dev = jax.devices()[0]
    log(f"device: {dev.platform}:{dev.device_kind}  total markers 2^{nlog}, "
        f"steps={steps}")

    def rate_for(cfg, tag):
        stepper = Stepper(cfg)
        state = load_particles(cfg, jax.random.PRNGKey(7))
        state = stepper.initial_field(state)
        ma, mb = stepper.make_multi_step(steps), stepper.make_multi_step(3 * steps)
        np.asarray(ma(state).electric)
        np.asarray(mb(state).electric)
        tas, tbs = [], []
        for _ in range(4):
            t0 = time.perf_counter()
            np.asarray(ma(state).electric)
            tas.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            np.asarray(mb(state).electric)
            tbs.append(time.perf_counter() - t0)
        elapsed = max((min(tbs) - min(tas)) / 2, 1e-30)
        total = cfg.nspecies * cfg.nparticle_max
        rate = 2.0 * total * steps / elapsed
        log(f"{tag}: {rate:.3e} pushes/s ({elapsed / steps * 1e3:.2f} ms/step,"
            f" {cfg.nspecies} species x {cfg.nparticle_max} markers)")
        return rate

    base = bump_on_tail_default(
        nx=1024, nparticle_max=n_total, dtype="float32", verbosity=0)
    rate_a = rate_for(base, "A: 1 species")

    sp = SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.0, density=0.5,
                       v0=3.0)
    cfg_b = dataclasses.replace(
        base, nparticle_max=n_total // 2,
        equilibrium=Equilibrium.MAXWELLIAN,
        species=(sp, dataclasses.replace(sp, v0=-3.0)),
        lx=2.0 * np.pi / 0.2,
    ).validate()
    rate_b = rate_for(cfg_b, "B: 2 species")

    payload = {
        "metric": "multispecies_pushes_per_sec",
        "rate_1species": rate_a,
        "rate_2species_same_total": rate_b,
        "per_marker_ratio_2sp_over_1sp": rate_b / rate_a,
        "n_total": n_total, "steps": steps,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(payload, fh, indent=1)
        log(f"wrote {out_path}")
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
