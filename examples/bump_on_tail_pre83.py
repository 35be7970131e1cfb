"""Reproduce the reference's headline case: the electron bump-on-tail
instability of Phys. Rev. E 83, 056402 (2011) Sec. V.A.2 (reference
README.md:107-109; all parameters are this framework's defaults, matching
src/pic1dp_input.F90).

Runs the linear growth phase, fits the growth rate from int E^2 dx exactly
as tools/runinfo.py does (gamma = energy-fit / 2), and compares against the
kinetic dispersion relation.  Expected output (to a few %%, marker noise):

    theory:    omega = 1.1694 + 0.0838i
    simulated: gamma = 0.083  (rel. err < 5%)

Usage:  python examples/bump_on_tail_pre83.py [nparticles] [t_end]
        (defaults 1_000_000 and 100; the reference default is 6.4e6 markers
        to t=500, which also saturates nonlinearly — try it on a GPU)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from pic1dp_tpu import Simulation
from pic1dp_tpu.analysis.dispersion import Dispersion, species_for_config
from pic1dp_tpu.config import bump_on_tail_default


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    t_end = float(sys.argv[2]) if len(sys.argv) > 2 else 100.0

    cfg = bump_on_tail_default(nparticle_max=n, time_max=t_end,
                               output_interval=1.0, verbosity=1)
    k = 2.0 * np.pi / cfg.lx
    omega = Dispersion(species_for_config(cfg), k).solve_omega()
    print(f"dispersion theory: k = {k:.4f}, omega = {omega:.6g}")

    snaps = []
    Simulation(cfg).run(snapshot_callback=snaps.append)

    t = np.array([s["time"] for s in snaps])
    e = np.array([s["field_energy"] for s in snaps])
    # fit over the linear-growth window (past the initial transient, before
    # saturation at |E|^2 ~ 1e-2)
    lo, hi = 25.0, min(t_end * 0.85, 70.0)
    m = (t >= lo) & (t <= hi) & (e > 0)
    gamma = np.polyfit(t[m], np.log(e[m]), 1)[0] / 2.0
    rel = abs(gamma - omega.imag) / omega.imag
    print(f"simulated gamma = {gamma:.5f}  (theory {omega.imag:.5f}, "
          f"rel. err {rel:.2%})")
    return 0 if rel < 0.10 else 1


if __name__ == "__main__":
    sys.exit(main())
