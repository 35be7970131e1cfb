"""Tests that need an NVIDIA GPU: the fused kernels compiled by Triton
(they have no CPU build; their arithmetic is pinned in interpret mode by
test_spectral_path.py).  Run on a card with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pytestmark = pytest.mark.gpu


def test_auto_picks_kernels_on_gpu(gpu_only):
    from pic1dp_tpu.config import DepositMethod, bump_on_tail_default
    from pic1dp_tpu.core.step import Stepper

    cfg = bump_on_tail_default(nparticle_max=4096, verbosity=0)
    assert Stepper(cfg).deposit_method == DepositMethod.PALLAS


def test_compiled_kernels_match_xla_step(gpu_only):
    import chip_smoke

    res = chip_smoke.phase_kernels(n=2**20, nx=1024, solve_nx=4096)
    assert set(res) == {"nmode1", "nmode4", "two_species", "solve"}
