"""Explicit particle-shape matrix S in COO form and its transposed-pair
application.

The reference's iptclshape strategies 1-3 materialize the N_p x nx hat
interpolation matrix S (2 nonzeros per row) — as a PETSc AIJ matrix rebuilt
(1) or refilled (2) each step, or as per-particle (index, weight) arrays (3)
(reference src/pic1dp_particle.F90:275-350) — and apply the pair

    deposit:  rho_grid = S^T w     (reference src/pic1dp_interaction.F90:46-78)
    gather:   E_p      = S  E      (reference :213-220)

Here the AIJ variants collapse to strategy 3's array form: the COO triplet
is (ix0, ix1, w0, w1) per particle, assembled once per substep position and
applied with segment-sum (deposit) and take (gather).  This is the stored-
shape cross-check path; the production hot loop is matrix-free spectral
(cfg.shape = MATRIX_FREE, ops/spectral.py) and never assembles S.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from pic1dp_tpu.ops.interp import hat_x


class ShapeMatrix(NamedTuple):
    """COO hat-shape matrix for one set of particle positions: row i has
    value w0[i] at column ix0[i] and w1[i] at column ix1[i]."""

    ix0: jnp.ndarray
    ix1: jnp.ndarray
    w0: jnp.ndarray
    w1: jnp.ndarray
    nx: int

    @classmethod
    def assemble(cls, x: jnp.ndarray, lx, nx: int) -> "ShapeMatrix":
        """particle_compute_shape_x analogue (reference
        src/pic1dp_particle.F90:275-350); x must already be wrapped."""
        ix0, ix1, w0, w1 = hat_x(x, lx, nx)
        return cls(ix0=ix0, ix1=ix1, w0=w0, w1=w1, nx=nx)

    def deposit(self, val: jnp.ndarray, method: str = "segment",
                chunk: int = 16384) -> jnp.ndarray:
        """S^T val -> (nx,) grid (the SpMV-transpose deposition).

        method "segment" lowers to XLA's scatter (wins at large nx: measured
        3x over the flat one-hot at nx=4096); "onehot" is the chunked
        compare-select-reduce on the stored COO (the measured winner at
        nx <= ~1024, where XLA fuses the (chunk, nx) one-hot into the reduce
        end-to-end — the same per-nx crossover as the position-path
        deposit_ops table in docs/performance.md, now selectable on the
        stored-S path too so the EXPLICIT pair no longer pays a ~4x
        off-winner penalty at small nx)."""
        if method == "onehot":
            return self._deposit_onehot(val, chunk)
        idx = jnp.concatenate([self.ix0.reshape(-1), self.ix1.reshape(-1)])
        w = jnp.concatenate([(self.w0 * val).reshape(-1),
                             (self.w1 * val).reshape(-1)])
        return jax.ops.segment_sum(w, idx, num_segments=self.nx)

    def _deposit_onehot(self, val: jnp.ndarray, chunk: int) -> jnp.ndarray:
        """Chunked flat one-hot S^T val from the stored COO entries (same
        contraction as ops/deposit.deposit_onehot, minus the hat_x
        recompute)."""
        ix0, ix1 = self.ix0.reshape(-1), self.ix1.reshape(-1)
        wv0 = (self.w0 * val).reshape(-1)
        wv1 = (self.w1 * val).reshape(-1)
        n = ix0.shape[0]
        chunk = min(chunk, n) or 1
        rem = (-n) % chunk
        if rem:
            ix0 = jnp.pad(ix0, (0, rem))
            ix1 = jnp.pad(ix1, (0, rem))
            wv0 = jnp.pad(wv0, (0, rem))
            wv1 = jnp.pad(wv1, (0, rem))
        nchunk = ix0.shape[0] // chunk
        args = tuple(a.reshape(nchunk, chunk) for a in (ix0, ix1, wv0, wv1))
        iota = jnp.arange(self.nx, dtype=jnp.int32)

        def body(acc, a):
            i0, i1, v0, v1 = a
            contrib = jnp.where(i0[:, None] == iota, v0[:, None], 0.0) + \
                      jnp.where(i1[:, None] == iota, v1[:, None], 0.0)
            return acc + jnp.sum(contrib, axis=0), None

        grid0 = jnp.zeros((self.nx,), wv0.dtype) + 0.0 * wv0[0]
        grid, _ = jax.lax.scan(body, grid0, args)
        return grid

    def gather(self, grid: jnp.ndarray, method: str = "take",
               chunk: int = 16384) -> jnp.ndarray:
        """S grid -> per-particle values (the SpMV gather).

        method "take" uses dynamic gather (the fastest on the H100 and the
        CPU); "twolevel" uses the factorized one-hot contraction (a test
        reference — see ops/gather.py)."""
        if method == "twolevel":
            from pic1dp_tpu.ops.gather import take_twolevel

            shp = self.ix0.shape
            g0 = take_twolevel(self.ix0.reshape(-1), grid, self.nx,
                               chunk=chunk).reshape(shp)
            g1 = take_twolevel(self.ix1.reshape(-1), grid, self.nx,
                               chunk=chunk).reshape(shp)
            return self.w0 * g0 + self.w1 * g1
        return self.w0 * jnp.take(grid, self.ix0) + \
            self.w1 * jnp.take(grid, self.ix1)

    def todense(self) -> jnp.ndarray:
        """Dense S (testing only; rows = flattened particles)."""
        n = self.ix0.size
        rows = jnp.arange(n)
        dense = jnp.zeros((n, self.nx), self.w0.dtype)
        dense = dense.at[rows, self.ix0.reshape(-1)].add(self.w0.reshape(-1))
        dense = dense.at[rows, self.ix1.reshape(-1)].add(self.w1.reshape(-1))
        return dense
