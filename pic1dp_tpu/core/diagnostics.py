"""Diagnostics: energies, particle-distribution snapshots, |delta f|(v).

Reference equivalents:
  * field/kinetic energies: src/pic1dp_output.F90:117-172
  * x-v and v distribution snapshots on the nx_opd x nv_opd diagnostic grid:
    src/pic1dp_output.F90:196-477
  * |delta f|(v) resonance histogram driving merge/remove/split:
    src/pic1dp_particle.F90:356-403

The x-v deposition is a chunked outer-product contraction: for a chunk of
C particles the x hat one-hot Xoh (C x nx_opd) and v hat one-hot Voh
(C x nv_opd) give the 2-D histogram as the matmul (Voh * val)^T @ Xoh — no
scatter anywhere.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from pic1dp_tpu import distributions as dist
from pic1dp_tpu.config import Config
from pic1dp_tpu.core.state import SimState
from pic1dp_tpu.ops.interp import hat_v, hat_v_clipped, hat_x


class Energies(NamedTuple):
    field: jnp.ndarray    # scalar: int E^2 dx = sum(E^2) * lx / nx (reference :120-124)
    marker: jnp.ndarray   # (ns,): sum_live v^2          (reference :126-135)
    total: jnp.ndarray    # (ns,): sum v^2 p             (reference :137-143)
    pertb: jnp.ndarray    # (ns,): sum v^2 w (delta-f)   (reference :145-171)


def energies(cfg: Config, sp: dist.SpeciesParams, state: SimState,
             axis_name: str | None = None) -> Energies:
    """Set axis_name when the particle axis is sharded under shard_map: the
    per-shard partial sums are psum-reduced before any derived quantity."""
    def allsum(x):
        return jax.lax.psum(x, axis_name) if axis_name is not None else x

    field = jnp.sum(state.electric**2) * (cfg.lx / cfg.nx)
    v2 = jnp.where(state.live, state.v * state.v, 0.0)
    marker = allsum(jnp.sum(v2, axis=1))
    total = allsum(jnp.sum(v2 * state.p, axis=1))
    if cfg.deltaf:
        pertb = allsum(jnp.sum(v2 * state.w, axis=1))
        if cfg.linear:
            # linear: p = f0/g, perturbed energy must be added to get total
            # (reference src/pic1dp_output.F90:152-155)
            total = total + pertb
    else:
        # full-f: subtract the analytic equilibrium energy
        # (reference :156-170; the reference leaves two of the four cases
        # unimplemented — distributions.equilibrium_energy covers all four)
        pertb = total - dist.equilibrium_energy(cfg.equilibrium, sp, cfg.lx)[:, 0]
    return Energies(field=field, marker=marker, total=total, pertb=pertb)


class PtclDist(NamedTuple):
    """Per-species distribution snapshots (reference output_ptcldist).

    xv arrays have shape (ns, nv_opd, nx_opd); v arrays (ns, nv_opd).
    Order matches the reference record: marker g, total f, perturbed delta f.
    """

    markr_xv: jnp.ndarray
    total_xv: jnp.ndarray
    pertb_xv: jnp.ndarray
    markr_v: jnp.ndarray
    total_v: jnp.ndarray
    pertb_v: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("nx", "nv", "chunk"))
def deposit_xv(x, v, vals, lx, v_max, nx: int, nv: int, chunk: int = 16384):
    """Histogram vals (k, N) over the (nv, nx) diagnostic grid with hat
    weights in both coordinates; particles with |v| >= v_max are skipped
    (reference src/pic1dp_output.F90:239-315).

    Returns (hist_xv (k, nv, nx), hist_v (k, nv)).
    """
    k, n = vals.shape
    rem = (-n) % chunk
    if rem:
        x = jnp.pad(x, (0, rem))
        v = jnp.pad(v, (0, rem), constant_values=2.0 * v_max)  # outside -> masked
        vals = jnp.pad(vals, ((0, 0), (0, rem)))
    nchunk = x.shape[0] // chunk
    xc = x.reshape(nchunk, chunk)
    vc = v.reshape(nchunk, chunk)
    valc = vals.reshape(k, nchunk, chunk).transpose(1, 0, 2)
    iota_x = jnp.arange(nx, dtype=jnp.int32)
    iota_v = jnp.arange(nv, dtype=jnp.int32)

    def body(carry, args):
        acc_xv, acc_v = carry
        xs, vs, vl = args
        ix0, ix1, wx0, wx1 = hat_x(xs, lx, nx)
        iv0, iv1, wv0, wv1, inside = hat_v(vs, v_max, nv)
        wv0 = jnp.where(inside, wv0, 0.0)
        wv1 = jnp.where(inside, wv1, 0.0)
        xoh = jnp.where(ix0[:, None] == iota_x, wx0[:, None], 0.0) + \
              jnp.where(ix1[:, None] == iota_x, wx1[:, None], 0.0)
        voh = jnp.where(iv0[:, None] == iota_v, wv0[:, None], 0.0) + \
              jnp.where(iv1[:, None] == iota_v, wv1[:, None], 0.0)
        # (k, C, nv) weighted v one-hot, contracted with x one-hot
        wvoh = vl[:, :, None] * voh[None, :, :]
        acc_xv = acc_xv + jnp.einsum("kcj,ci->kji", wvoh, xoh,
                                     precision=jax.lax.Precision.HIGHEST)
        acc_v = acc_v + jnp.sum(wvoh, axis=1)
        return (acc_xv, acc_v), None

    # + 0 * vals[0, 0] propagates varying manual axes for shard_map (see
    # ops/deposit.py)
    zero = 0.0 * vals[0, 0]
    acc0 = (jnp.zeros((k, nv, nx), vals.dtype) + zero,
            jnp.zeros((k, nv), vals.dtype) + zero)
    (hist_xv, hist_v), _ = jax.lax.scan(body, acc0, (xc, vc, valc))
    return hist_xv, hist_v


def ptcldist(cfg: Config, sp: dist.SpeciesParams, state: SimState,
             chunk: int | None = None,
             axis_name: str | None = None) -> PtclDist:
    """Marker/total/perturbed distribution snapshots
    (reference src/pic1dp_output.F90:196-477).

    Under shard_map, pass axis_name: the RAW histograms are psum-reduced
    BEFORE normalization and (full-f) equilibrium subtraction — subtracting
    f0 per shard and then summing would remove it once per device."""
    chunk = chunk or cfg.deposit_chunk
    nx, nv = cfg.nx_opd, cfg.nv_opd
    delx_inv = nx / cfg.lx
    delv_inv = (nv - 1) / (2.0 * cfg.v_max)

    out_xv, out_v = [], []
    for s in range(cfg.nspecies):
        live = state.live[s]
        vals = jnp.stack([
            jnp.where(live, 1.0, 0.0),
            jnp.where(live, state.p[s], 0.0),
            jnp.where(live, state.w[s], 0.0),
        ]).astype(state.x.dtype)
        hxv, hv = deposit_xv(state.x[s], state.v[s], vals, cfg.lx, cfg.v_max,
                             nx, nv, chunk=min(chunk, state.x.shape[1]))
        out_xv.append(hxv)
        out_v.append(hv)
    hxv = jnp.stack(out_xv, axis=1)  # (3, ns, nv, nx)
    hv = jnp.stack(out_v, axis=1)    # (3, ns, nv)
    if axis_name is not None:
        hxv = jax.lax.psum(hxv, axis_name)
        hv = jax.lax.psum(hv, axis_name)

    markr_xv, total_xv, pertb_xv = hxv[0], hxv[1], hxv[2]
    markr_v, total_v, pertb_v = hv[0], hv[1], hv[2]

    if cfg.linear:
        # linear: p = f0/g, add perturbation for the total (reference :327-331)
        total_xv = total_xv + pertb_xv
        total_v = total_v + pertb_v

    # normalize by cell sizes (reference :360-369)
    markr_xv = markr_xv * (delx_inv * delv_inv)
    total_xv = total_xv * (delx_inv * delv_inv)
    markr_v = markr_v * delv_inv
    total_v = total_v * delv_inv
    if cfg.deltaf:
        pertb_xv = pertb_xv * (delx_inv * delv_inv)
        pertb_v = pertb_v * delv_inv
    else:
        # full-f: perturbed = total - analytic equilibrium (reference :370-453)
        vgrid = (jnp.arange(nv, dtype=state.x.dtype) / (nv - 1) * 2.0 - 1.0) * cfg.v_max
        f0v = dist.f0(cfg.equilibrium, sp, vgrid[None, :])  # (ns, nv)
        pertb_xv = total_xv - f0v[:, :, None]
        pertb_v = total_v - cfg.lx * f0v

    return PtclDist(markr_xv=markr_xv, total_xv=total_xv, pertb_xv=pertb_xv,
                    markr_v=markr_v, total_v=total_v, pertb_v=pertb_v)


@functools.partial(jax.jit, static_argnames=("nv", "chunk"))
def dist_pertb_abs_v(v, w, live, v_max, nv: int, chunk: int = 16384):
    """|delta f| deposited on the nv-point velocity grid, per species —
    drives merge/remove/split (reference particle_compute_dist_pertb_abs_v,
    src/pic1dp_particle.F90:356-403).  v, w, live: (ns, N) -> (ns, nv)."""
    ns, n = v.shape
    iv0, iv1, wv0, wv1, inside = hat_v(v, v_max, nv)
    val = jnp.where(live & inside, jnp.abs(w), 0.0)
    iota = jnp.arange(nv, dtype=jnp.int32)

    rem = (-n) % chunk
    if rem:
        iv0 = jnp.pad(iv0, ((0, 0), (0, rem)))
        iv1 = jnp.pad(iv1, ((0, 0), (0, rem)))
        wv0 = jnp.pad(wv0, ((0, 0), (0, rem)))
        wv1 = jnp.pad(wv1, ((0, 0), (0, rem)))
        val = jnp.pad(val, ((0, 0), (0, rem)))
    nchunk = iv0.shape[1] // chunk

    def per_species(args):
        i0, i1, w0, w1, vl = args

        def body(acc, a):
            i0c, i1c, w0c, w1c, vlc = a
            contrib = jnp.where(i0c[:, None] == iota, (w0c * vlc)[:, None], 0.0) + \
                      jnp.where(i1c[:, None] == iota, (w1c * vlc)[:, None], 0.0)
            return acc + jnp.sum(contrib, axis=0), None

        chunks = tuple(a.reshape(nchunk, chunk) for a in (i0, i1, w0, w1, vl))
        acc0 = jnp.zeros((nv,), vl.dtype) + 0.0 * vl[0]
        acc, _ = jax.lax.scan(body, acc0, chunks)
        return acc

    return jax.vmap(lambda *a: per_species(a))(iv0, iv1, wv0, wv1, val)
