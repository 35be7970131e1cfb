"""Charge deposition (scatter, S^T w in the vector-matrix formulation).

The reference deposits particle weights onto the grid either through a PETSc
shape-matrix transpose SpMV (reference src/pic1dp_interaction.F90:46-78) or a
per-rank local array accumulation followed by MPI_Allreduce (:80-151).

Two formulations are kept.  XLA's scatter-add (segment_sum, atomics on a
GPU) is the fast one at large nx.  The one-hot form turns the scatter into
a dense contraction: for a chunk of C particles build the hat "one-hot"
matrix H (C x nx) with w0 at column ix0 and w1 at column ix1, and reduce
over the particle axis — a reduction XLA fuses without materializing H in
device memory.  Chunks stream through a lax.scan carry so memory stays
O(chunk * nx).  core/step.py picks between them by nx.

Under pjit/shard_map with the particle axis sharded, each device reduces its
own chunk stream and the per-device partial grids are combined with a psum —
exactly the reference's replicate-and-Allreduce strategy (SURVEY.md 2.3).

The matrix-free hot loop never deposits on a grid: its fused kernels
(ops/pallas_kernels.py) accumulate mode projections instead.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from pic1dp_tpu.ops.interp import hat_x


def _pad_to_multiple(arrs, chunk: int, pad_values):
    n = arrs[0].shape[-1]
    rem = (-n) % chunk
    if rem == 0:
        return arrs, n
    padded = tuple(
        jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, rem)], constant_values=pv)
        for a, pv in zip(arrs, pad_values)
    )
    return padded, n


@functools.partial(jax.jit, static_argnames=("nx", "chunk"))
def deposit_onehot(x: jnp.ndarray, val: jnp.ndarray, lx, nx: int,
                   chunk: int = 16384) -> jnp.ndarray:
    """Deposit `val` at positions `x` (already wrapped into [0, lx)) onto an
    nx-cell periodic grid with hat weights.  x, val: (N,) -> (nx,)."""
    (x, val), _ = _pad_to_multiple((x, val), chunk, (0.0, 0.0))
    n = x.shape[0]
    nchunk = n // chunk
    xc = x.reshape(nchunk, chunk)
    vc = val.reshape(nchunk, chunk)
    iota = jnp.arange(nx, dtype=jnp.int32)

    def body(acc, args):
        xs, vs = args
        ix0, ix1, w0, w1 = hat_x(xs, lx, nx)
        # (chunk, nx) one-hot contributions; XLA fuses this into the reduce,
        # so the intermediate never hits HBM.
        contrib = jnp.where(ix0[:, None] == iota, (w0 * vs)[:, None], 0.0) + \
                  jnp.where(ix1[:, None] == iota, (w1 * vs)[:, None], 0.0)
        return acc + jnp.sum(contrib, axis=0), None

    # 0 * val[0] makes the carry inherit val's varying manual axes, so the
    # scan is valid both standalone and per-shard inside shard_map
    grid0 = jnp.zeros((nx,), dtype=val.dtype) + 0.0 * val[0]
    grid, _ = jax.lax.scan(body, grid0, (xc, vc))
    return grid


_LANES = 128  # the lo-digit radix


@functools.partial(jax.jit, static_argnames=("nx", "chunk"))
def deposit_twolevel(x: jnp.ndarray, val: jnp.ndarray, lx, nx: int,
                     chunk: int = 16384) -> jnp.ndarray:
    """Two-level factorized one-hot deposit (a test reference for the
    SpMV transpose).

    Splitting each cell index as ix = 128*hi + lo factorizes the (C, nx)
    one-hot into an outer product of a (C, nx/128) hi-one-hot and a (C, 128)
    lo-one-hot, so the whole deposit becomes the contraction

        grid2d[h, l] = sum_c hi_onehot[c, h] * (val*w)[c] * lo_onehot[c, l]

    which cuts the compare work per entry from nx to nx/128 + 128.
    Bitwise-equal contributions per particle; only the f32 summation order
    differs.  On the H100 it loses to both the flat one-hot and the scatter
    at every measured nx (PERF.md).
    """
    nhi = (nx + _LANES - 1) // _LANES
    (x, val), _ = _pad_to_multiple((x, val), chunk, (0.0, 0.0))
    n = x.shape[0]
    nchunk = n // chunk
    xc = x.reshape(nchunk, chunk)
    vc = val.reshape(nchunk, chunk)
    iota_hi = jnp.arange(nhi, dtype=jnp.int32)
    iota_lo = jnp.arange(_LANES, dtype=jnp.int32)

    def one(ix, wv):
        oh_hi = (ix // _LANES)[:, None] == iota_hi
        oh_lo = jnp.where((ix % _LANES)[:, None] == iota_lo, wv[:, None], 0.0)
        return jnp.einsum("ch,cl->hl", oh_hi.astype(wv.dtype), oh_lo,
                          precision=jax.lax.Precision.HIGHEST)

    def body(acc, args):
        xs, vs = args
        ix0, ix1, w0, w1 = hat_x(xs, lx, nx)
        return acc + one(ix0, w0 * vs) + one(ix1, w1 * vs), None

    grid0 = jnp.zeros((nhi, _LANES), dtype=val.dtype) + 0.0 * val[0]
    grid2d, _ = jax.lax.scan(body, grid0, (xc, vc))
    return grid2d.reshape(nhi * _LANES)[:nx]


@functools.partial(jax.jit, static_argnames=("nx",))
def deposit_segment(x: jnp.ndarray, val: jnp.ndarray, lx, nx: int) -> jnp.ndarray:
    """Scatter-add deposition via segment_sum (correctness baseline)."""
    ix0, ix1, w0, w1 = hat_x(x, lx, nx)
    idx = jnp.concatenate([ix0, ix1])
    w = jnp.concatenate([w0 * val, w1 * val])
    return jax.ops.segment_sum(w, idx, num_segments=nx)


def deposit(x, val, lx, nx: int, method: str = "onehot", chunk: int = 16384):
    """Dispatch on deposit method ('onehot' | 'twolevel' | 'segment')."""
    if method == "segment":
        return deposit_segment(x, val, lx, nx)
    if method == "twolevel":
        return deposit_twolevel(x, val, lx, nx,
                                chunk=min(chunk, x.shape[-1]) or 1)
    return deposit_onehot(x, val, lx, nx, chunk=min(chunk, x.shape[-1]) or 1)
