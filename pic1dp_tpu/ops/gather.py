"""Field gather (S E in the vector-matrix formulation).

The reference interpolates the replicated electric field to particle positions
with the same hat weights used for deposition (reference
src/pic1dp_interaction.F90:239-258, or MatMult(S, E) for the explicit-matrix
strategies :213-220).

A random gather from a tiny (nx <= 4096) replicated grid vector is a
dynamic gather; jnp.take is the production choice (the fastest on the H100
and the CPU, PERF.md).  The one-hot and two-level forms are test references.
The matrix-free hot loop gathers from its kept modes instead (ops/spectral.py,
ops/pallas_kernels.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from pic1dp_tpu.ops.interp import hat_x


@functools.partial(jax.jit, static_argnames=("nx",))
def gather_take(x: jnp.ndarray, grid: jnp.ndarray, lx, nx: int) -> jnp.ndarray:
    """Interpolate grid (nx,) to positions x (N,), hat weights, periodic."""
    ix0, ix1, w0, w1 = hat_x(x, lx, nx)
    return w0 * jnp.take(grid, ix0) + w1 * jnp.take(grid, ix1)


@functools.partial(jax.jit, static_argnames=("nx", "chunk"))
def gather_onehot(x: jnp.ndarray, grid: jnp.ndarray, lx, nx: int,
                  chunk: int = 16384) -> jnp.ndarray:
    """One-hot contraction gather: E_p = H @ grid, chunked.  Avoids dynamic
    gather entirely (one matvec per chunk)."""
    n = x.shape[0]
    rem = (-n) % chunk
    xp = jnp.pad(x, (0, rem)) if rem else x
    nchunk = xp.shape[0] // chunk
    xc = xp.reshape(nchunk, chunk)
    iota = jnp.arange(nx, dtype=jnp.int32)

    def body(xs):
        ix0, ix1, w0, w1 = hat_x(xs, lx, nx)
        onehot = jnp.where(ix0[:, None] == iota, w0[:, None], 0.0) + \
                 jnp.where(ix1[:, None] == iota, w1[:, None], 0.0)
        return jnp.matmul(onehot, grid, precision=jax.lax.Precision.HIGHEST)

    out = jax.lax.map(body, xc).reshape(-1)
    return out[:n]


_LANES = 128  # the lo-digit radix


def _grid2d(grid: jnp.ndarray, nx: int):
    nhi = (nx + _LANES - 1) // _LANES
    return jnp.pad(grid, (0, nhi * _LANES - nx)).reshape(nhi, _LANES)


def _take2(ix: jnp.ndarray, grid2d: jnp.ndarray) -> jnp.ndarray:
    """grid2d.reshape(-1)[ix] via the factorized one-hot: with
    ix = 128*hi + lo,

        out[c] = sum_l (hi_onehot[c, :] @ grid2d)[l] * lo_onehot[c, l]

    — one matmul against the (nx/128, 128) grid tile plus nx/128 + 128
    compares per entry."""
    nhi = grid2d.shape[0]
    oh_hi = ((ix // _LANES)[:, None]
             == jnp.arange(nhi, dtype=jnp.int32)).astype(grid2d.dtype)
    rows = jnp.einsum("ch,hl->cl", oh_hi, grid2d,
                      precision=jax.lax.Precision.HIGHEST)
    iota_lo = jnp.arange(_LANES, dtype=jnp.int32)
    return jnp.sum(jnp.where((ix % _LANES)[:, None] == iota_lo, rows, 0.0),
                   axis=1)


@functools.partial(jax.jit, static_argnames=("nx", "chunk"))
def take_twolevel(ix: jnp.ndarray, grid: jnp.ndarray, nx: int,
                  chunk: int = 16384) -> jnp.ndarray:
    """grid[ix] (flat int32 indices) via the factorized one-hot, chunked."""
    g2 = _grid2d(grid, nx)
    n = ix.shape[0]
    rem = (-n) % chunk
    ixp = jnp.pad(ix, (0, rem)) if rem else ix
    ixc = ixp.reshape(ixp.shape[0] // chunk, chunk)
    out = jax.lax.map(lambda c: _take2(c, g2), ixc).reshape(-1)
    return out[:n]


@functools.partial(jax.jit, static_argnames=("nx", "chunk"))
def gather_twolevel(x: jnp.ndarray, grid: jnp.ndarray, lx, nx: int,
                    chunk: int = 16384) -> jnp.ndarray:
    """Two-level factorized one-hot gather (the SpMV pair partner of
    deposit_twolevel): hat weights at positions x, both neighbor lookups
    fused into one chunked map."""
    g2 = _grid2d(grid, nx)
    n = x.shape[0]
    rem = (-n) % chunk
    xp = jnp.pad(x, (0, rem)) if rem else x
    xc = xp.reshape(xp.shape[0] // chunk, chunk)

    def body(xs):
        ix0, ix1, w0, w1 = hat_x(xs, lx, nx)
        return w0 * _take2(ix0, g2) + w1 * _take2(ix1, g2)

    out = jax.lax.map(body, xc).reshape(-1)
    return out[:n]


def gather(x, grid, lx, nx: int, method: str = "take", chunk: int = 16384):
    if method == "onehot":
        return gather_onehot(x, grid, lx, nx, chunk=min(chunk, x.shape[-1]) or 1)
    if method == "twolevel":
        return gather_twolevel(x, grid, lx, nx,
                               chunk=min(chunk, x.shape[-1]) or 1)
    return gather_take(x, grid, lx, nx)
