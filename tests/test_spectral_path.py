"""The matrix-free spectral hot path (cfg.shape = MATRIX_FREE) must agree
with the explicit grid-histogram path (EXPLICIT) to float64 roundoff: hat
deposition followed by the partial DFT is linear, so accumulating mode
projections per particle is the same operator as deposit-to-grid +
MatMultTranspose (reference src/pic1dp_interaction.F90:96-135 +
src/pic1dp_field.F90:230-240), differing only in summation order."""

import dataclasses

import jax
import numpy as np
import pytest

from pic1dp_tpu.config import ParticleShape, bump_on_tail_default, landau_damping
from pic1dp_tpu.core.loading import load_particles
from pic1dp_tpu.core.step import Stepper


def _cases():
    yield "bump_on_tail", bump_on_tail_default(
        nx=192, nparticle_max=40000, dtype="float64", verbosity=0)
    yield "landau", landau_damping(
        nx=64, nparticle=30000, dtype="float64", verbosity=0)
    yield "landau_linear", dataclasses.replace(
        landau_damping(nx=64, nparticle=30000, dtype="float64", verbosity=0),
        linear=True)
    yield "multimode", dataclasses.replace(
        landau_damping(nx=64, nparticle=30000, dtype="float64", verbosity=0),
        modes=(1, 2, 3), init_modes=(1, 2), init_amp_cos=(1e-5, 0.0),
        init_amp_sin=(1e-4, 5e-5))


@pytest.mark.parametrize("name,cfg", list(_cases()), ids=lambda c: c if isinstance(c, str) else "")
def test_spectral_matches_grid(name, cfg):
    cfg_grid = dataclasses.replace(cfg, shape=ParticleShape.EXPLICIT)
    st_s = Stepper(cfg)
    st_g = Stepper(cfg_grid)
    state = st_s.initial_field(load_particles(cfg, jax.random.PRNGKey(0)))
    a = b = state
    for _ in range(5):
        a = st_s.step(a)
        b = st_g.step(b)
    for field in ("x", "v", "w", "mode_re", "mode_im", "electric"):
        va, vb = np.asarray(getattr(a, field)), np.asarray(getattr(b, field))
        scale = np.max(np.abs(vb)) + 1e-300
        np.testing.assert_allclose(va / scale, vb / scale, atol=1e-12,
                                   err_msg=f"{name}:{field}")


def test_push_pair_spectral_matches_grid():
    cfg = landau_damping(nx=64, nparticle=30000, dtype="float64", verbosity=0)
    cfg_grid = dataclasses.replace(cfg, shape=ParticleShape.EXPLICIT)
    st_s, st_g = Stepper(cfg), Stepper(cfg_grid)
    state = st_s.initial_field(load_particles(cfg, jax.random.PRNGKey(1)))
    a = jax.jit(st_s.push_pair)(state)
    b = jax.jit(st_g.push_pair)(state)
    for field in ("x", "v", "w"):
        va, vb = np.asarray(getattr(a, field)), np.asarray(getattr(b, field))
        scale = np.max(np.abs(vb)) + 1e-300
        np.testing.assert_allclose(va / scale, vb / scale, atol=1e-12)


def test_multi_step_matches_python_loop():
    cfg = landau_damping(nx=64, nparticle=20000, dtype="float64", verbosity=0)
    st = Stepper(cfg)
    state = st.initial_field(load_particles(cfg, jax.random.PRNGKey(2)))
    a = st.make_multi_step(4)(state)
    b = state
    for _ in range(4):
        b = st.step(b)
    np.testing.assert_allclose(np.asarray(a.x), np.asarray(b.x), atol=0)
    np.testing.assert_allclose(np.asarray(a.electric), np.asarray(b.electric),
                               atol=1e-300)


def _pallas_cases():
    """Every fused-kernel stream variant: (has_v, has_w) x equilibria."""
    from pic1dp_tpu.config import two_stream

    bot = bump_on_tail_default(nx=192, nparticle_max=4096, dtype="float64",
                               verbosity=0)
    lan = landau_damping(nx=64, nparticle=4096, dtype="float64", verbosity=0)
    yield "bot_nonlinear_deltaf", bot                        # v + w streams
    yield "landau_linear", dataclasses.replace(lan, linear=True)   # w only
    yield "landau_fullf", dataclasses.replace(
        landau_damping(nx=64, nparticle=4096, amp=1e-2, dtype="float64",
                       verbosity=0), deltaf=False)           # v only
    yield "two_stream2", two_stream(nx=64, nparticle=4096, dtype="float64",
                                    verbosity=0)
    yield "multimode", dataclasses.replace(
        lan, modes=(1, 2, 3), init_modes=(1, 2), init_amp_cos=(1e-5, 0.0),
        init_amp_sin=(1e-4, 5e-5))
    # 2 species with DIFFERENT parameters: exercises the species-fused
    # kernel's per-block constant selects (charge, mass, v0, temperature
    # all distinct so no select degenerates to a baked float)
    from pic1dp_tpu.config import Equilibrium, SpeciesConfig
    yield "two_species_maxwellian", dataclasses.replace(
        two_stream(nx=64, nparticle=4096, dtype="float64", verbosity=0),
        equilibrium=Equilibrium.MAXWELLIAN,
        species=(SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.0,
                               density=0.6, v0=2.5),
                 SpeciesConfig(charge=-0.5, mass=2.0, temperature=0.5,
                               density=0.4, v0=-3.0)))
    # mixed bump-on-tail pair with one degenerate (beamless) species: the
    # fused kernel must take the clamped-log_ratio branch for species 1
    # while species 0 keeps the full two-Gaussian ratio form
    yield "two_species_bump_mixed", dataclasses.replace(
        bump_on_tail_default(nx=64, nparticle_max=4096, dtype="float64",
                             verbosity=0),
        species=(SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.0,
                               temperature2=0.25, density=0.9, v0=4.0),
                 SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.5,
                               temperature2=0.25, density=1.0, v0=0.0)))


@pytest.mark.parametrize("name,cfg", list(_pallas_cases()),
                         ids=lambda c: c if isinstance(c, str) else "")
def test_pallas_matches_spectral(name, cfg):
    """The fused Pallas substeps (interpret mode on CPU) must reproduce the
    XLA spectral path to float64 roundoff for every (linear, deltaf,
    equilibrium) stream variant — including kernel 2's recomputation of the
    midpoint state and the single-exponential -f0'/f0 forms."""
    from pic1dp_tpu.config import DepositMethod

    cfg_p = dataclasses.replace(cfg, deposit_method=DepositMethod.PALLAS)
    st_x = Stepper(cfg)
    st_p = Stepper(cfg_p, interpret=True)
    assert st_p.deposit_method == DepositMethod.PALLAS
    state = st_x.initial_field(load_particles(cfg, jax.random.PRNGKey(3)))
    a, b = state, state
    for _ in range(3):
        a = st_x.step(a)
        b = st_p.step(b)
    for field in ("x", "v", "w", "mode_re", "mode_im"):
        va, vb = np.asarray(getattr(a, field)), np.asarray(getattr(b, field))
        scale = np.max(np.abs(va)) + 1e-300
        np.testing.assert_allclose(vb / scale, va / scale, atol=1e-12,
                                   err_msg=f"{name}:{field}")


@pytest.mark.parametrize("modes", [(1,), (1, 2, 3)],
                         ids=["single", "multimode-recurrence"])
def test_pallas_f32_poly_trig_matches_xla(modes):
    """The f32 kernels take cos/sin of the integer grid angles from a
    table gather instead of computing them.  Against the XLA f32 spectral
    path the per-step divergence must stay at trig-roundoff level."""
    from pic1dp_tpu.config import DepositMethod

    cfg = bump_on_tail_default(nx=192, nparticle_max=8192, dtype="float32",
                               verbosity=0)
    if len(modes) > 1:
        cfg = dataclasses.replace(cfg, modes=modes, init_modes=(1, 2),
                                  init_amp_cos=(1e-5, 0.0),
                                  init_amp_sin=(1e-4, 5e-5))
    cfg_p = dataclasses.replace(cfg, deposit_method=DepositMethod.PALLAS)
    st_x, st_p = Stepper(cfg), Stepper(cfg_p, interpret=True)
    state = st_x.initial_field(load_particles(cfg, jax.random.PRNGKey(5)))
    a, b = state, state
    for _ in range(5):
        a = st_x.step(a)
        b = st_p.step(b)
    np.testing.assert_allclose(np.asarray(b.x), np.asarray(a.x),
                               rtol=0, atol=5e-5)
    np.testing.assert_allclose(np.asarray(b.v), np.asarray(a.v),
                               rtol=0, atol=1e-5)
    scale = np.max(np.abs(np.asarray(a.w))) + 1e-30
    np.testing.assert_allclose(np.asarray(b.w) / scale,
                               np.asarray(a.w) / scale, rtol=0, atol=1e-4)


def test_pallas_bump_on_tail_degenerate_density():
    """density=1.0 (pure core) / 0.0 (pure beam) collapse the two-Gaussian
    ratio form to a single Maxwellian; the log in the ratio constant must
    not domain-error and the kernel must match the XLA path."""
    from pic1dp_tpu.config import DepositMethod, SpeciesConfig

    for density in (1.0, 0.0):
        cfg = bump_on_tail_default(nx=64, nparticle_max=2048, dtype="float64",
                                   verbosity=0)
        sp = dataclasses.replace(cfg.species[0], density=density)
        cfg = dataclasses.replace(cfg, species=(sp,))
        cfg_p = dataclasses.replace(cfg, deposit_method=DepositMethod.PALLAS)
        st_x, st_p = Stepper(cfg), Stepper(cfg_p, interpret=True)
        state = st_x.initial_field(load_particles(cfg, jax.random.PRNGKey(7)))
        a = st_x.step(st_x.step(state))
        b = st_p.step(st_p.step(state))
        scale = np.max(np.abs(np.asarray(a.w))) + 1e-300
        np.testing.assert_allclose(np.asarray(b.w) / scale,
                                   np.asarray(a.w) / scale, atol=1e-12,
                                   err_msg=f"density={density}")


def test_bf16_weights_matches_f32():
    """cfg.bf16_weights quantizes ONLY the p storage and the midpoint w1 in
    the substep-2 drive (docs/performance.md error budget): after one step
    x must be bitwise-identical to the f32 run (the position update never
    touches p or w1), v agrees to field-perturbation level, and w within the
    ~0.4%/step quantization budget.  Dtypes: p bfloat16, everything else
    f32."""
    from pic1dp_tpu.config import DepositMethod

    cfg = bump_on_tail_default(nx=192, nparticle_max=4096, dtype="float32",
                               deposit_method=DepositMethod.PALLAS,
                               verbosity=0)
    cfg_b = dataclasses.replace(cfg, bf16_weights=True)
    st, st_b = Stepper(cfg, interpret=True), Stepper(cfg_b, interpret=True)
    state = st.initial_field(load_particles(cfg, jax.random.PRNGKey(11)))
    state_b = st_b.initial_field(load_particles(cfg_b, jax.random.PRNGKey(11)))
    assert str(state_b.p.dtype) == "bfloat16"
    assert str(state_b.w.dtype) == "float32"
    # identical markers modulo the p quantization
    np.testing.assert_array_equal(np.asarray(state_b.x), np.asarray(state.x))
    np.testing.assert_allclose(
        np.asarray(state_b.p, np.float64), np.asarray(state.p, np.float64),
        rtol=5e-3)

    a, b = st.step(state), st_b.step(state_b)
    assert str(b.p.dtype) == "bfloat16" and str(b.w.dtype) == "float32"
    np.testing.assert_array_equal(np.asarray(b.x), np.asarray(a.x))
    np.testing.assert_allclose(np.asarray(b.v), np.asarray(a.v),
                               rtol=0, atol=1e-5)
    for _ in range(2):
        a, b = st.step(a), st_b.step(b)
    scale = np.max(np.abs(np.asarray(a.w))) + 1e-30
    np.testing.assert_allclose(np.asarray(b.w) / scale,
                               np.asarray(a.w) / scale, rtol=0, atol=2e-2)
    scale = np.max(np.abs(np.asarray(a.mode_re))) + 1e-30
    np.testing.assert_allclose(np.asarray(b.mode_re) / scale,
                               np.asarray(a.mode_re) / scale,
                               rtol=0, atol=2e-2)


def test_bf16_weights_xla_fallback_matches():
    """The XLA spectral path reads the bf16 p through ordinary promotion
    and rounds w1 like the kernels — at an arbitrary capacity the run must
    work and stay close to its f32 twin."""
    cfg = bump_on_tail_default(nx=64, nparticle_max=3072, dtype="float32",
                               verbosity=0)
    cfg_b = dataclasses.replace(cfg, bf16_weights=True)
    st, st_b = Stepper(cfg), Stepper(cfg_b)
    state = st.initial_field(load_particles(cfg, jax.random.PRNGKey(13)))
    state_b = st_b.initial_field(load_particles(cfg_b, jax.random.PRNGKey(13)))
    a, b = st.step(state), st_b.step(state_b)
    assert str(b.p.dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(b.x), np.asarray(a.x))
    scale = np.max(np.abs(np.asarray(a.w))) + 1e-30
    np.testing.assert_allclose(np.asarray(b.w) / scale,
                               np.asarray(a.w) / scale, rtol=0, atol=1e-2)


def test_bf16_shifted_multispecies_warns():
    """bf16_weights + multiple strongly shifted species has a measured
    post-saturation divergence (docs/performance.md round 5) — Stepper
    construction must warn; the equivalent composite single-species config
    must NOT."""
    import warnings

    from pic1dp_tpu.config import (DepositMethod, Equilibrium, SpeciesConfig,
                                   two_stream)

    sp = SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.0, density=0.5,
                       v0=3.0)
    cfg = dataclasses.replace(
        two_stream(nparticle=4096, dtype="float32", verbosity=0,
                   deposit_method=DepositMethod.PALLAS),
        equilibrium=Equilibrium.MAXWELLIAN,
        species=(sp, dataclasses.replace(sp, v0=-3.0)),
        bf16_weights=True).validate()
    with pytest.warns(RuntimeWarning, match="strongly shifted"):
        Stepper(cfg)
    cfg_comp = two_stream(nparticle=4096, dtype="float32", verbosity=0,
                          deposit_method=DepositMethod.PALLAS,
                          bf16_weights=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        Stepper(cfg_comp)  # composite single-species: no warning


def test_f32_config_stays_f32_under_x64():
    """Device-equivalence guarantee: with jax_enable_x64 on (the CPU test
    environment), a dtype=float32 config must produce float32 state through
    the XLA spectral path — otherwise the "f32 path" tested on CPU is not
    the f32 path that runs on the GPU (the reference's PetscReal is a single
    global kind, src/pic1dp_global.F90:28-31; ours must be just as airtight).
    Guards against np.float64 scalar constants promoting a jitted chain
    (the round-1 mode_trig bug)."""
    assert jax.config.jax_enable_x64
    cfg = bump_on_tail_default(nx=192, nparticle_max=4096, dtype="float32",
                               verbosity=0)
    st = Stepper(cfg)
    state = st.initial_field(load_particles(cfg, jax.random.PRNGKey(17)))
    for _ in range(2):
        state = st.step(state)
    for field in ("x", "v", "p", "w", "mode_re", "mode_im", "electric", "rho"):
        assert str(getattr(state, field).dtype) == "float32", field
    # the fused push pair (used by the scheduled-optimization path) too
    out = jax.jit(st.push_pair)(state)
    for field in ("x", "v", "p", "w"):
        assert str(getattr(out, field).dtype) == "float32", field


def test_twolevel_stepper_matches_spectral():
    """A MATRIX_FREE run forced onto the TWOLEVEL grid-deposit/gather pair
    agrees with the spectral hot path to f64 roundoff — the factorized
    one-hot is the same S / S^T operator."""
    from pic1dp_tpu.config import DepositMethod

    cfg = landau_damping(nx=256, nparticle=30000, dtype="float64",
                         verbosity=0)
    cfg_tl = dataclasses.replace(cfg, deposit_method=DepositMethod.TWOLEVEL)
    st_s, st_t = Stepper(cfg), Stepper(cfg_tl)
    assert st_t.deposit_method == DepositMethod.TWOLEVEL
    state = st_s.initial_field(load_particles(cfg, jax.random.PRNGKey(2)))
    a = b = state
    for _ in range(5):
        a = st_s.step(a)
        b = st_t.step(b)
    for field in ("x", "v", "w", "mode_re", "mode_im", "electric"):
        va, vb = np.asarray(getattr(a, field)), np.asarray(getattr(b, field))
        scale = np.max(np.abs(vb)) + 1e-300
        np.testing.assert_allclose(va / scale, vb / scale, atol=1e-12,
                                   err_msg=field)


@pytest.mark.parametrize("n", [1, 1000, 1025, 3000])
def test_pallas_masked_tail_matches_spectral(n):
    """Capacities that are not a multiple of the kernel block: the masked
    tail must neither deposit nor be written, at any length."""
    from pic1dp_tpu.config import DepositMethod
    from pic1dp_tpu.ops.pallas_kernels import BLOCK

    assert n % BLOCK or n < BLOCK
    cfg = bump_on_tail_default(nx=64, nparticle_max=n, dtype="float64",
                               verbosity=0)
    st_x = Stepper(cfg)
    st_p = Stepper(dataclasses.replace(
        cfg, deposit_method=DepositMethod.PALLAS), interpret=True)
    state = st_x.initial_field(load_particles(cfg, jax.random.PRNGKey(n)))
    a, b = st_x.step(state), st_p.step(state)
    for field in ("x", "v", "w", "mode_re", "mode_im"):
        va, vb = np.asarray(getattr(a, field)), np.asarray(getattr(b, field))
        assert va.shape == vb.shape
        scale = np.max(np.abs(va)) + 1e-300
        np.testing.assert_allclose(vb / scale, va / scale, atol=1e-12,
                                   err_msg=f"n={n}:{field}")


def _multi_step_cases():
    from pic1dp_tpu.config import DepositMethod, Equilibrium, SpeciesConfig

    yield "bf16_one_species", bump_on_tail_default(
        nx=192, nparticle_max=4096, dtype="float32",
        deposit_method=DepositMethod.PALLAS, bf16_weights=True, verbosity=0)
    sp = SpeciesConfig(charge=-1.0, mass=1.0, temperature=1.0, density=0.5,
                       v0=2.0)
    yield "two_species", dataclasses.replace(
        bump_on_tail_default(nx=64, nparticle_max=3000, dtype="float32",
                             deposit_method=DepositMethod.PALLAS,
                             verbosity=0),
        equilibrium=Equilibrium.MAXWELLIAN,
        species=(sp, dataclasses.replace(sp, v0=-2.0))).validate()


@pytest.mark.parametrize("name,cfg", list(_multi_step_cases()),
                         ids=lambda c: c if isinstance(c, str) else "")
def test_pallas_multi_step_matches_per_step(name, cfg):
    """The kernels' lax.scan (in-place x/v/w writes) must equal per-step
    stepping exactly, with the state shapes and dtypes unchanged."""
    st = Stepper(cfg, interpret=True)
    state = st.initial_field(load_particles(cfg, jax.random.PRNGKey(19)))
    a = st.make_multi_step(3)(state)
    b = state
    for _ in range(3):
        b = st.step(b)
    for field in ("x", "v", "p", "w", "mode_re", "mode_im"):
        va = np.asarray(getattr(a, field))
        np.testing.assert_array_equal(va, np.asarray(getattr(b, field)),
                                      err_msg=f"{name}:{field}")
        assert getattr(a, field).shape == getattr(state, field).shape
        assert getattr(a, field).dtype == getattr(state, field).dtype


def _strong_weights(state):
    """A saturated-looking state: weights at 30% of p and a strong field,
    so that rounding w1 to bf16 moves w2 well above f32 roundoff."""
    w = 0.3 * state.p.astype("float32") * jax.numpy.sin(state.x)
    return dataclasses.replace(state, w=w, mode_re=state.mode_re + 0.05,
                               mode_im=state.mode_im - 0.03)


def test_bf16_weights_kernel_matches_xla_quantization():
    """With bf16_weights the XLA step and the kernels round w1 at the same
    place, so they agree to f32 roundoff — far closer than either is to the
    f32-weight run, which differs by the quantization itself."""
    from pic1dp_tpu.config import DepositMethod

    cfg_b = bump_on_tail_default(nx=192, nparticle_max=4096, dtype="float32",
                                 bf16_weights=True, verbosity=0)
    st_x = Stepper(cfg_b)
    st_k = Stepper(dataclasses.replace(
        cfg_b, deposit_method=DepositMethod.PALLAS), interpret=True)
    state = _strong_weights(
        st_x.initial_field(load_particles(cfg_b, jax.random.PRNGKey(29))))
    # the same markers with p widened to f32: only the w1 rounding differs
    cfg_f = dataclasses.replace(cfg_b, bf16_weights=False)
    state_f = dataclasses.replace(state, p=state.p.astype("float32"))
    a, b, c = st_x.step(state), st_k.step(state), Stepper(cfg_f).step(state_f)
    scale = np.max(np.abs(np.asarray(a.w))) + 1e-30
    kernel_vs_xla = np.max(np.abs(np.asarray(b.w) - np.asarray(a.w))) / scale
    quantization = np.max(np.abs(np.asarray(c.w) - np.asarray(a.w))) / scale
    assert kernel_vs_xla < 1e-5
    assert quantization > 10 * kernel_vs_xla


def test_bf16_w1_quantization_identity_xla():
    """The XLA step rounds w1 to bf16 in the substep-2 drive only: x2, v2
    and the midpoint field are bitwise those of the unrounded step on the
    same (bf16-representable) p; only w2 moves, by the rounded drive
    term."""
    cfg_b = bump_on_tail_default(nx=64, nparticle_max=2048, dtype="float32",
                                 bf16_weights=True, verbosity=0)
    cfg_f = dataclasses.replace(cfg_b, bf16_weights=False)
    st_b, st_f = Stepper(cfg_b), Stepper(cfg_f)
    state = _strong_weights(
        st_b.initial_field(load_particles(cfg_b, jax.random.PRNGKey(31))))
    state_f = dataclasses.replace(state, p=state.p.astype("float32"))
    (xb, vb, wb), modes_b, _ = jax.jit(st_b._spectral_pushes)(state)
    (xf, vf, wf), modes_f, _ = jax.jit(st_f._spectral_pushes)(state_f)
    np.testing.assert_array_equal(np.asarray(xb), np.asarray(xf))
    np.testing.assert_array_equal(np.asarray(vb), np.asarray(vf))
    for mb, mf in zip(modes_b, modes_f):
        np.testing.assert_array_equal(np.asarray(mb), np.asarray(mf))
    dw = np.max(np.abs(np.asarray(wb) - np.asarray(wf)))
    assert 0.0 < dw < 1e-2 * np.max(np.abs(np.asarray(wf)))


def test_pallas_without_interpret_raises_off_gpu():
    """Off the GPU the fused step never falls back and never interprets
    unless asked: PALLAS without interpret=True raises."""
    from pic1dp_tpu.config import DepositMethod

    cfg = bump_on_tail_default(nx=64, nparticle_max=2048, dtype="float32",
                               deposit_method=DepositMethod.PALLAS,
                               verbosity=0)
    st = Stepper(cfg)
    state = st.initial_field(load_particles(cfg, jax.random.PRNGKey(5)))
    with pytest.raises(ValueError, match="interpret=True"):
        st.step(state)
    with pytest.raises(ValueError, match="interpret=True"):
        st.make_multi_step(2)(state)


@pytest.mark.parametrize("nx,expected", [(64, "onehot"), (192, "onehot"),
                                         (1024, "segment"), (4096, "segment")])
def test_auto_method_off_gpu(nx, expected):
    """AUTO never picks the kernels off the GPU; the grid-path deposit is
    the one-hot below nx=512 and XLA's scatter from there on."""
    for shape in (ParticleShape.MATRIX_FREE, ParticleShape.EXPLICIT):
        cfg = bump_on_tail_default(nx=nx, nparticle_max=1024, shape=shape,
                                   verbosity=0)
        assert Stepper(cfg).deposit_method.value == expected
