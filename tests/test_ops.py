"""Unit tests for interpolation, deposition, gather, and the spectral solve.

Covers the oracle properties SURVEY.md section 4 calls for: hat-weight
partition of unity, deposition/gather adjointness (S vs S^T), and the
spectral solve against analytic cos/sin fields.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pic1dp_tpu.ops import deposit as dep
from pic1dp_tpu.ops import gather as gat
from pic1dp_tpu.ops.interp import hat_v, hat_v_clipped, hat_x, wrap_x
from pic1dp_tpu.ops.spectral import SpectralOperator

LX = 2.0 * np.pi / 0.36
NX = 192


def rand_x(key, n, lx=LX):
    return jax.random.uniform(key, (n,), jnp.float64) * lx


class TestInterp:
    def test_wrap(self):
        x = jnp.array([-0.1, 0.0, LX - 1e-9, LX, LX + 0.3, -LX - 0.2])
        w = wrap_x(x, LX)
        assert jnp.all((w >= 0) & (w < LX))
        np.testing.assert_allclose(w[0], LX - 0.1, rtol=1e-12)
        np.testing.assert_allclose(w[4], 0.3, rtol=1e-9)

    def test_partition_of_unity(self):
        x = rand_x(jax.random.PRNGKey(0), 1000)
        ix0, ix1, w0, w1 = hat_x(x, LX, NX)
        np.testing.assert_allclose(w0 + w1, 1.0, atol=1e-12)
        assert jnp.all((w0 >= 0) & (w0 <= 1))
        assert jnp.all(ix1 == (ix0 + 1) % NX)

    def test_hat_v_mask(self):
        v = jnp.array([-9.0, -7.9, 0.0, 7.9, 9.0])
        iv0, iv1, w0, w1, inside = hat_v(v, 8.0, 128)
        np.testing.assert_array_equal(inside, [False, True, True, True, False])
        np.testing.assert_allclose((w0 + w1)[inside], 1.0, atol=1e-12)

    def test_hat_v_clipped_boundary(self):
        # clipped samples take the boundary value with full weight
        # (reference src/pic1dp_particle.F90:452-466)
        v = jnp.array([-10.0, 10.0])
        iv0, iv1, w0, w1 = hat_v_clipped(v, 8.0, 128)
        np.testing.assert_array_equal(iv0, [0, 127])
        np.testing.assert_allclose(w0, 1.0)
        np.testing.assert_allclose(w1, 0.0)


class TestDeposit:
    def test_total_conservation(self):
        key = jax.random.PRNGKey(1)
        x = rand_x(key, 5000)
        val = jax.random.normal(jax.random.PRNGKey(2), (5000,), jnp.float64)
        grid = dep.deposit_onehot(x, val, LX, NX, chunk=512)
        np.testing.assert_allclose(jnp.sum(grid), jnp.sum(val), rtol=1e-10)

    def test_onehot_matches_segment(self):
        x = rand_x(jax.random.PRNGKey(3), 3000)
        val = jax.random.normal(jax.random.PRNGKey(4), (3000,), jnp.float64)
        g1 = dep.deposit_onehot(x, val, LX, NX, chunk=1000)
        g2 = dep.deposit_segment(x, val, LX, NX)
        np.testing.assert_allclose(g1, g2, rtol=1e-10, atol=1e-12)

    def test_single_particle(self):
        # particle exactly halfway between cells 3 and 4
        x = jnp.array([(3.5) * LX / NX])
        val = jnp.array([2.0])
        grid = dep.deposit_onehot(x, val, LX, NX, chunk=1)
        np.testing.assert_allclose(grid[3], 1.0, rtol=1e-12)
        np.testing.assert_allclose(grid[4], 1.0, rtol=1e-12)
        assert jnp.count_nonzero(grid) == 2

    def test_periodic_wraparound_cell(self):
        # particle in the last cell deposits onto cells nx-1 and 0
        x = jnp.array([LX * (NX - 0.25) / NX])
        val = jnp.array([1.0])
        grid = dep.deposit_onehot(x, val, LX, NX, chunk=1)
        np.testing.assert_allclose(grid[NX - 1], 0.25, rtol=1e-10)
        np.testing.assert_allclose(grid[0], 0.75, rtol=1e-10)

    @pytest.mark.parametrize("nx", [NX, 128, 4096])
    def test_twolevel_matches_onehot(self, nx):
        """The factorized (hi, lo)-digit deposit is the same operator as the
        flat one-hot — per-particle contributions identical, only the f64
        summation order differs."""
        x = rand_x(jax.random.PRNGKey(3), 3000)
        val = jax.random.normal(jax.random.PRNGKey(4), (3000,), jnp.float64)
        g1 = dep.deposit_onehot(x, val, LX, nx, chunk=1000)
        g2 = dep.deposit_twolevel(x, val, LX, nx, chunk=1000)
        np.testing.assert_allclose(g2, g1, rtol=1e-12, atol=1e-14)


class TestGatherAdjoint:
    def test_gather_matches_onehot(self):
        x = rand_x(jax.random.PRNGKey(5), 2000)
        grid = jax.random.normal(jax.random.PRNGKey(6), (NX,), jnp.float64)
        e1 = gat.gather_take(x, grid, LX, NX)
        e2 = gat.gather_onehot(x, grid, LX, NX, chunk=512)
        np.testing.assert_allclose(e1, e2, rtol=1e-10, atol=1e-12)

    def test_adjointness(self):
        """<deposit(x, val), grid> == <val, gather(x, grid)> — the S / S^T
        transposed-pair property of the vector-matrix formulation
        (reference doc/formulation.tex; SURVEY.md section 4)."""
        x = rand_x(jax.random.PRNGKey(7), 4000)
        val = jax.random.normal(jax.random.PRNGKey(8), (4000,), jnp.float64)
        grid = jax.random.normal(jax.random.PRNGKey(9), (NX,), jnp.float64)
        lhs = jnp.vdot(dep.deposit_onehot(x, val, LX, NX, chunk=1024), grid)
        rhs = jnp.vdot(val, gat.gather_take(x, grid, LX, NX))
        np.testing.assert_allclose(lhs, rhs, rtol=1e-10)

    @pytest.mark.parametrize("nx", [NX, 4096])
    def test_twolevel_gather_matches_take(self, nx):
        x = rand_x(jax.random.PRNGKey(5), 2000)
        grid = jax.random.normal(jax.random.PRNGKey(6), (nx,), jnp.float64)
        e1 = gat.gather_take(x, grid, LX, nx)
        e2 = gat.gather_twolevel(x, grid, LX, nx, chunk=512)
        np.testing.assert_allclose(e2, e1, rtol=1e-12, atol=1e-14)

    def test_take_twolevel_matches_take(self):
        ix = jax.random.randint(jax.random.PRNGKey(10), (3000,), 0, 4096)
        grid = jax.random.normal(jax.random.PRNGKey(11), (4096,), jnp.float64)
        np.testing.assert_array_equal(
            np.asarray(gat.take_twolevel(ix, grid, 4096, chunk=512)),
            np.asarray(jnp.take(grid, ix)))

    def test_shape_matrix_gather_twolevel(self):
        from pic1dp_tpu.ops.shape_matrix import ShapeMatrix

        x = rand_x(jax.random.PRNGKey(12), 2000)
        grid = jax.random.normal(jax.random.PRNGKey(13), (NX,), jnp.float64)
        s = ShapeMatrix.assemble(x, LX, NX)
        np.testing.assert_allclose(
            np.asarray(s.gather(grid, method="twolevel", chunk=512)),
            np.asarray(s.gather(grid)), rtol=1e-12, atol=1e-14)

    def test_twolevel_pair_adjointness(self):
        x = rand_x(jax.random.PRNGKey(7), 4000)
        val = jax.random.normal(jax.random.PRNGKey(8), (4000,), jnp.float64)
        grid = jax.random.normal(jax.random.PRNGKey(9), (NX,), jnp.float64)
        lhs = jnp.vdot(dep.deposit_twolevel(x, val, LX, NX, chunk=1024), grid)
        rhs = jnp.vdot(val, gat.gather_twolevel(x, grid, LX, NX, chunk=1024))
        np.testing.assert_allclose(lhs, rhs, rtol=1e-10)


class TestSpectral:
    def test_cosine_charge(self):
        """rho = cos(k x) must give E = sin(k x) / k for a kept mode
        (dE/dx = rho), the check reference field_test does by eye
        (src/pic1dp_field.F90:276-309)."""
        for mode in (1, 3):
            op = SpectralOperator.create(NX, (1, 2, 3), LX, jnp.float64)
            xgrid = np.arange(NX) / NX * LX
            k = 2.0 * np.pi * mode / LX
            rho = jnp.asarray(np.cos(k * xgrid))
            e, mre, mim = op.solve(rho)
            np.testing.assert_allclose(e, np.sin(k * xgrid) / k, atol=1e-10)

    def test_sine_charge(self):
        op = SpectralOperator.create(NX, (2,), LX, jnp.float64)
        xgrid = np.arange(NX) / NX * LX
        k = 2.0 * np.pi * 2 / LX
        rho = jnp.asarray(np.sin(k * xgrid))
        e, _, _ = op.solve(rho)
        np.testing.assert_allclose(e, -np.cos(k * xgrid) / k, atol=1e-10)

    def test_unkept_mode_filtered(self):
        """Charge in a mode not in `modes` must produce no field — the
        partial DFT keeps only configured modes (reference
        src/pic1dp_field.F90:176-210)."""
        op = SpectralOperator.create(NX, (1,), LX, jnp.float64)
        xgrid = np.arange(NX) / NX * LX
        k5 = 2.0 * np.pi * 5 / LX
        e, mre, mim = op.solve(jnp.asarray(np.cos(k5 * xgrid)))
        np.testing.assert_allclose(e, 0.0, atol=1e-10)

    def test_mode_component_conventions(self):
        """E-mode components match the reference's sign/normalization:
        for rho = A sin(k x), E = -(A/k) cos(k x) = 2*mode_re*cos with
        mode_re = -A/(2k), mode_im = 0 (src/pic1dp_field.F90:230-257)."""
        op = SpectralOperator.create(NX, (1,), LX, jnp.float64)
        xgrid = np.arange(NX) / NX * LX
        k = 2.0 * np.pi / LX
        amp = 0.7
        e, mre, mim = op.solve(jnp.asarray(amp * np.sin(k * xgrid)))
        np.testing.assert_allclose(mre[0], -amp / (2 * k), rtol=1e-10)
        np.testing.assert_allclose(mim[0], 0.0, atol=1e-12)


class TestShapeMatrix:
    """COO shape matrix (ops/shape_matrix.py): adjoint transposed pair,
    partition of unity, agreement with the matrix-free operators."""

    def _mat(self, n=500, nx=32, lx=7.3, seed=0):
        from pic1dp_tpu.ops.shape_matrix import ShapeMatrix

        x = jax.random.uniform(jax.random.PRNGKey(seed), (n,), jnp.float64) * lx
        return x, ShapeMatrix.assemble(x, lx, nx)

    def test_partition_of_unity(self):
        _, s = self._mat()
        np.testing.assert_allclose(np.asarray(s.w0 + s.w1), 1.0, atol=1e-12)

    def test_dense_consistency(self):
        _, s = self._mat()
        dense = np.asarray(s.todense())
        val = np.linspace(-1, 1, 500)
        np.testing.assert_allclose(np.asarray(s.deposit(jnp.asarray(val))),
                                   dense.T @ val, atol=1e-12)
        grid = np.sin(np.arange(32))
        np.testing.assert_allclose(np.asarray(s.gather(jnp.asarray(grid))),
                                   dense @ grid, atol=1e-12)

    def test_adjointness(self):
        """<S v, g> == <v, S^T g> — deposition and gather are exact
        transposes (SURVEY.md section 4 test strategy)."""
        _, s = self._mat()
        v = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (500,), jnp.float64))
        g = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (32,), jnp.float64))
        lhs = float(np.dot(np.asarray(s.gather(jnp.asarray(g))), v))
        rhs = float(np.dot(np.asarray(s.deposit(jnp.asarray(v))), g))
        assert lhs == pytest.approx(rhs, rel=1e-12)

    def test_deposit_onehot_matches_segment(self):
        """The stored-COO flat one-hot deposit (the AUTO choice below
        nx=512) must equal the segment_sum deposit to
        summation-order tolerance, including the chunk-padding tail."""
        _, s = self._mat(n=500)  # 500 % chunk != 0 -> exercises padding
        val = jax.random.normal(jax.random.PRNGKey(5), (500,), jnp.float64)
        a = np.asarray(s.deposit(val, method="segment"))
        b = np.asarray(s.deposit(val, method="onehot", chunk=128))
        np.testing.assert_allclose(b, a, atol=1e-12)
        # stacked (ns, n) input shape, as deposit_charge passes it
        val2 = val.reshape(2, 250)
        from pic1dp_tpu.ops.shape_matrix import ShapeMatrix

        x2 = jax.random.uniform(jax.random.PRNGKey(6), (2, 250),
                                jnp.float64) * 7.3
        s2 = ShapeMatrix.assemble(x2, 7.3, 32)
        np.testing.assert_allclose(
            np.asarray(s2.deposit(val2, method="onehot", chunk=64)),
            np.asarray(s2.deposit(val2, method="segment")), atol=1e-12)

    def test_matches_matrix_free_ops(self):
        from pic1dp_tpu.ops import deposit as deposit_ops
        from pic1dp_tpu.ops import gather as gather_ops

        x, s = self._mat()
        val = jax.random.normal(jax.random.PRNGKey(3), (500,), jnp.float64)
        np.testing.assert_allclose(
            np.asarray(s.deposit(val)),
            np.asarray(deposit_ops.deposit(x, val, 7.3, 32, method="onehot")),
            atol=1e-12)
        grid = jax.random.normal(jax.random.PRNGKey(4), (32,), jnp.float64)
        np.testing.assert_allclose(
            np.asarray(s.gather(grid)),
            np.asarray(gather_ops.gather(x, grid, 7.3, 32)), atol=1e-12)
