"""Nonlinear two-stream instability to saturation (BASELINE.md config 3:
256 cells, 1e6 markers, k=0.2, counter-streaming Maxwellians at +/-3 vth —
the reference's iptcldist=2 equilibrium, src/pic1dp_input.F90:52).

Checks, in the reference's own verification methodology (SURVEY.md section 4):
  1. growth rate gamma = d ln(int E^2 dx)/dt / 2 over the linear window vs
     the kinetic dispersion root (Z-function),
  2. saturation: the field-energy peak (findpeak_energy semantics,
     reference tools/OutputData.py:172-180),
  3. total-energy conservation (KE/2 + int E^2 dx / 2) through saturation.

Usage:  python examples/two_stream.py          (GPU: seconds; CPU: minutes)
Env:    PIC1DP_EX_N (markers, default 1e6), PIC1DP_EX_TMAX (default 60).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from pic1dp_tpu import Simulation
from pic1dp_tpu.analysis.dispersion import Dispersion, species_for_config
from pic1dp_tpu.config import two_stream


def main() -> int:
    n = int(float(os.environ.get("PIC1DP_EX_N", 1_000_000)))
    tmax = float(os.environ.get("PIC1DP_EX_TMAX", 80.0))

    import jax

    dtype = "float32" if jax.devices()[0].platform != "cpu" else "float64"
    cfg = two_stream(nparticle=n, time_max=tmax, dtype=dtype,
                     output_interval=0.5, verbosity=1)

    disp = Dispersion(species_for_config(cfg), 0.2)
    disp._guesses = [0.01 + 0.3j, 0.02 + 0.5j, 0.05 + 0.4j]
    omega = disp.solve_omega()
    print(f"dispersion theory: omega = {omega:.6g}")

    snaps = []
    Simulation(cfg).run(snapshot_callback=snaps.append)
    t = np.array([s["time"] for s in snaps])
    e = np.array([s["field_energy"] for s in snaps])

    m = (t >= 15.0) & (t <= 35.0)
    gamma = np.polyfit(t[m], np.log(e[m]), 1)[0] / 2.0
    rel = abs(gamma - omega.imag) / omega.imag
    print(f"simulated gamma = {gamma:.5f}  (theory {omega.imag:.5f}, "
          f"rel. err {rel:.2%})")

    # saturation = first local max after the linear phase (findpeak_energy
    # semantics, reference tools/OutputData.py:172-180)
    ipk = next((i for i in range(1, len(e) - 1)
                if t[i] > 35.0 and e[i] >= e[i - 1] and e[i] > e[i + 1]),
               int(np.argmax(e)))
    print(f"saturation: int E^2 dx peaks at {e[ipk]:.4g} (t = {t[ipk]:.1f})")

    ke = np.array([float(np.sum(s["total"])) for s in snaps])
    etot = 0.5 * ke + 0.5 * e
    drift = float(np.max(np.abs(etot - etot[0])) / ke[0])
    print(f"total-energy drift: {drift:.2e} of the kinetic energy")

    ok = rel < 0.08 and t[ipk] < tmax - 2.0 and drift < 2e-3
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
