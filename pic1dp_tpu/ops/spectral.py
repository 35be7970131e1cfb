"""Spectral (partial-DFT) Poisson solver.

The reference solves Gauss's law dE/dx = rho by keeping only a configured set
of Fourier modes: it assembles an nx-by-nmode cosine matrix and an nx-by-nmode
(-sine) matrix as PETSc AIJ matrices (reference src/pic1dp_field.F90:176-210)
and applies them as distributed SpMV pairs per step (:218-270).

Here the same partial DFT is two tiny dense matmuls on the replicated field
(nx <= 4096, nmode ~ 1), which compile to a handful of small ops and fuse
into the surrounding step.

Conventions (must match the reference bit-for-bit in structure so growth-rate
comparisons are apples-to-apples, reference src/pic1dp_field.F90:218-257):

    Fre[ix, m] = cos(2 pi mode_m ix / nx)
    Fim[ix, m] = -sin(2 pi mode_m ix / nx)
    mode_im = -(Fre^T rho) / nx           (:231-234)
    mode_re = +(Fim^T rho) / nx           (:236-239)
    mode_re *= grad_inv;  mode_im *= grad_inv,  grad_inv_m = lx/(2 pi mode_m)
                                          (:158-174, :242-248)
    E = 2 * (Fre @ mode_re + Fim @ mode_im)  (:250-257)

which is exactly E_k = rho_k / (i k) restricted to the kept modes, with the
factor 2 accounting for the conjugate half of the spectrum.  The mode_re /
mode_im vectors after the grad_inv multiply are the E-field Fourier components
written to the output stream (reference src/pic1dp_output.F90:177-181).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# float32 matrix products run in TF32 on tensor-core GPUs unless asked for
# full precision; the field and the written E/rho streams need all digits
_HI = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HI)


class SpectralOperator(NamedTuple):
    """Precomputed partial-DFT matrices and inverse-gradient diagonal."""

    fre: jnp.ndarray        # (nx, nmode) cos
    fim: jnp.ndarray        # (nx, nmode) -sin
    grad_inv: jnp.ndarray   # (nmode,) 1 / k_m = lx / (2 pi mode_m)

    @classmethod
    def create(cls, nx: int, modes: tuple[int, ...], lx: float, dtype) -> "SpectralOperator":
        ix = np.arange(nx)[:, None]
        m = np.asarray(modes)[None, :]
        theta = 2.0 * np.pi / nx * m * ix
        fre = np.cos(theta)
        fim = -np.sin(theta)
        grad_inv = lx / (2.0 * np.pi * np.asarray(modes, dtype=np.float64))
        return cls(
            fre=jnp.asarray(fre, dtype=dtype),
            fim=jnp.asarray(fim, dtype=dtype),
            grad_inv=jnp.asarray(grad_inv, dtype=dtype),
        )

    def solve(self, rho: jnp.ndarray):
        """rho (nx,) -> (E (nx,), mode_re (nmode,), mode_im (nmode,))."""
        nx = self.fre.shape[0]
        dtype = rho.dtype
        mode_im = -_mm(self.fre.T, rho) / nx
        mode_re = _mm(self.fim.T, rho) / nx
        mode_re = mode_re * self.grad_inv
        mode_im = mode_im * self.grad_inv
        electric = 2.0 * (_mm(self.fre, mode_re) + _mm(self.fim, mode_im))
        return electric.astype(dtype), mode_re, mode_im

    def e_grid(self, mode_re: jnp.ndarray, mode_im: jnp.ndarray) -> jnp.ndarray:
        """E(x) on the grid from the E-field mode components
        (reference src/pic1dp_field.F90:250-257)."""
        return 2.0 * (_mm(self.fre, mode_re) + _mm(self.fim, mode_im))

    def rho_grid_from_projections(self, p_c: jnp.ndarray, p_s: jnp.ndarray,
                                  lx: float) -> jnp.ndarray:
        """Kept-mode reconstruction of the charge density from the raw
        particle projections of `project_modes` (diagnostic use: the exact
        grid rho additionally contains the modes the solver discards)."""
        rho_re = p_c * (1.0 / lx)
        rho_im = -p_s * (1.0 / lx)
        return 2.0 * (_mm(self.fre, rho_re) + _mm(self.fim, rho_im))


# ---- matrix-free (iptclshape=4-style) spectral hot path -------------------
#
# The hot loop never touches an nx-sized grid: because hat deposition followed
# by the partial DFT is linear, the mode projections are accumulated directly
# per particle,
#
#     p_c[m] = sum_i a_i (w0_i cos(th_m(ix0_i)) + w1_i cos(th_m(ix1_i)))
#     p_s[m] = sum_i a_i (w0_i sin(th_m(ix0_i)) + w1_i sin(th_m(ix1_i)))
#
# with th_m(j) = 2 pi m j / nx the INTEGER grid angles, so the result equals
# the reference's deposit-to-grid + MatMultTranspose composition
# (src/pic1dp_interaction.F90:96-135 then src/pic1dp_field.F90:230-240)
# exactly, up to float summation order.  Likewise the gather is the kept-mode
# expansion of E evaluated at the same two neighbor cells, equal to the
# reference's VecScatter + hat interpolation (src/pic1dp_interaction.F90:239-258)
# of the mode-reconstructed grid E.  This turns the classic PIC
# scatter/gather bottleneck into pure elementwise work + reductions.
#
# The angle at the second neighbor is obtained by a constant-angle rotation
# (theta1 = theta0 + 2 pi m / nx holds under the periodic wrap too), saving
# half the transcendentals.


def _hat_fracs(x, lx, nx: int):
    """ix0 and hat weights (shared across modes)."""
    s = x * (nx / lx)
    ix0 = jnp.floor(s)
    frac = s - ix0
    ix0 = jnp.clip(ix0, 0.0, float(nx - 1))
    return ix0, 1.0 - frac, frac


def mode_trig(x, lx, nx: int, modes: tuple[int, ...]):
    """Per-mode cos/sin at the two hat-neighbor grid angles.

    Returns (w0, w1, [(c0, s0, c1, s1)] per mode); all arrays shaped like x.
    """
    ix0, w0, w1 = _hat_fracs(x, lx, nx)
    # Every scalar constant below is typed to x.dtype: a bare np.float64
    # scalar would silently promote the whole f32 trig chain (and thus e_p
    # and w) to f64 under jax_enable_x64, so the "f32 path" tested on CPU
    # would not be the f32 path that runs on the GPU.  The constants themselves
    # are computed in f64 first for accuracy, then narrowed.
    scalar = np.dtype(x.dtype).type
    out = []
    for m in modes:
        step = 2.0 * np.pi * m / nx
        theta0 = ix0 * scalar(step)
        c0 = jnp.cos(theta0)
        s0 = jnp.sin(theta0)
        cd, sd = scalar(np.cos(step)), scalar(np.sin(step))
        c1 = c0 * cd - s0 * sd
        s1 = s0 * cd + c0 * sd
        out.append((c0, s0, c1, s1))
    return w0, w1, out


def project_modes(trig, val):
    """Raw mode projections (p_c, p_s), each (nmode,), of a hat-deposited
    particle cloud; `val` = per-particle deposit value (0 for dead markers,
    charge folded in), `trig` = mode_trig(x_deposit, ...)."""
    w0, w1, per_mode = trig
    p_c = jnp.stack([jnp.sum(val * (w0 * c0 + w1 * c1))
                     for (c0, s0, c1, s1) in per_mode])
    p_s = jnp.stack([jnp.sum(val * (w0 * s0 + w1 * s1))
                     for (c0, s0, c1, s1) in per_mode])
    return p_c, p_s


def solve_modes_from_projections(p_c, p_s, grad_inv, lx: float):
    """E-field mode components from raw projections: the reference's
    (1/nx)-normalized transform plus grad_inv multiply
    (src/pic1dp_field.F90:230-248), composed with rho = grid * nx / lx."""
    mode_re = -p_s * (grad_inv / lx)
    mode_im = -p_c * (grad_inv / lx)
    return mode_re, mode_im


def efield_at(trig, mode_re, mode_im):
    """E hat-interpolated to the particles of `trig` from mode components."""
    w0, w1, per_mode = trig
    e = None
    for i, (c0, s0, c1, s1) in enumerate(per_mode):
        term = (w0 * c0 + w1 * c1) * mode_re[i] - (w0 * s0 + w1 * s1) * mode_im[i]
        e = term if e is None else e + term
    return 2.0 * e
