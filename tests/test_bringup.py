"""GPU bring-up guarantees that the CPU can check: float32 matrix products
pinned to full precision, the compile-cache directory, and chip_smoke.py's
phases at tiny sizes (its device check refuses the CPU)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import chip_smoke  # noqa: E402


def _dot_precisions(jaxpr):
    """Precision params of every dot_general in a jaxpr, sub-jaxprs
    included (scan, map, pjit bodies)."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append((eqn.params["precision"],
                        [v.aval.dtype for v in eqn.invars]))
        for val in eqn.params.values():
            for sub in (val if isinstance(val, (tuple, list)) else (val,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    out.extend(_dot_precisions(inner))
    return out


def _matmul_case(name):
    """(fn, args) of one float32 function with matrix products."""
    from pic1dp_tpu.core import diagnostics
    from pic1dp_tpu.ops import deposit, gather
    from pic1dp_tpu.ops.spectral import SpectralOperator

    f32 = jnp.float32
    op = SpectralOperator.create(64, (1, 2), 10.0, f32)
    rho = jnp.ones((64,), f32)
    modes = jnp.ones((2,), f32)
    x = jnp.linspace(0.0, 9.9, 300, dtype=f32)
    return {
        "solve": (op.solve, (rho,)),
        "e_grid": (op.e_grid, (modes, modes)),
        "rho_grid": (lambda a, b: op.rho_grid_from_projections(a, b, 10.0),
                     (modes, modes)),
        "gather_onehot": (lambda x, g: gather.gather_onehot(
            x, g, 10.0, 64, chunk=128), (x, rho)),
        "gather_twolevel": (lambda x, g: gather.gather_twolevel(
            x, g, 10.0, 64, chunk=128), (x, rho)),
        "deposit_twolevel": (lambda x, v: deposit.deposit_twolevel(
            x, v, 10.0, 64, chunk=128), (x, x)),
        "ptcldist_histogram": (lambda x, v, w: diagnostics.deposit_xv(
            x, v, w, 10.0, 6.0, 16, 16, chunk=128),
            (x, x - 5.0, jnp.ones((3, 300), f32))),
    }[name]


@pytest.mark.parametrize("name", [
    "solve", "e_grid", "rho_grid", "gather_onehot", "gather_twolevel",
    "deposit_twolevel", "ptcldist_histogram"])
def test_f32_matmuls_pin_highest_precision(name):
    """A float32 matrix product runs in TF32 on a tensor-core GPU unless
    asked for full precision; every one on the field, gather and snapshot
    paths must carry Precision.HIGHEST."""
    fn, args = _matmul_case(name)
    dots = _dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr)
    assert dots, name
    for prec, dtypes in dots:
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec), (name, prec, dtypes)


def test_compile_cache_env_var_wins(tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the directory in use."""
    code = ("import jax; from pic1dp_tpu.utils.compile_cache import "
            "enable_compilation_cache as e; d = e(); "
            "print(d, jax.config.jax_compilation_cache_dir)")
    env = {**os.environ, "JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == [str(tmp_path), str(tmp_path)]


def test_no_code_sets_another_cache_dir():
    """Only utils/compile_cache.py touches the cache directory, and it
    sets one only when the variable left it unset."""
    paths = [f for f in os.listdir(_REPO) if f.endswith(".py")]
    for top in ("pic1dp_tpu", "bench", "examples"):
        for root, _, files in os.walk(os.path.join(_REPO, top)):
            paths += [os.path.relpath(os.path.join(root, f), _REPO)
                      for f in files if f.endswith(".py")]
    hits = []
    for path in sorted(paths):
        with open(os.path.join(_REPO, path)) as fh:
            if "jax_compilation_cache_dir" in fh.read():
                hits.append(path)
    assert hits == [os.path.join("pic1dp_tpu", "utils", "compile_cache.py")]


def test_chip_smoke_main_path_cpu(tmp_path):
    res = chip_smoke.phase_main_path(
        str(tmp_path), overrides=("nparticle_max=20000", "time_max=5.0",
                                  "nx=64"),
        window=(0.0, 5.0), tol=None)
    assert res["snapshots"] == 11
    assert np.isfinite(res["gamma"]) and np.isfinite(res["rel_err"])
    assert os.path.getsize(tmp_path / "pic1dp.out") > 0


def test_chip_smoke_kernels_cpu():
    res = chip_smoke.phase_kernels(n=4096, nx=64, solve_nx=256,
                                   interpret=True)
    assert set(res) == {"nmode1", "nmode4", "two_species", "solve"}


def test_chip_smoke_capacity_cpu():
    res = chip_smoke.phase_capacity(n=4096, nx=64, steps=2)
    assert "peak_bytes_in_use" in res


def test_chip_smoke_cards_cpu(devices):
    res = chip_smoke.phase_cards(ncards=4, n=8192, nx=64, steps=2)
    assert res["mode_rel_diff"] <= chip_smoke.STEP_TOL["mode"]


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    """No accelerator, or no repo beside the script: non-zero exit and no
    result line."""
    script = os.path.join(_REPO, "chip_smoke.py")
    cwd = _REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, script], env=env, cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
