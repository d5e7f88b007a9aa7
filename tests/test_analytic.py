"""Analytic golden tests from the reference math notebook
(``examples/b_TV_discretizations_math.ipynb`` cell 0): for the 5x5 single-hot
image A (A[2,2]=1), TVU(A) = TVD(A) = 2 + sqrt(2), TVC(A) = 2, TVH(A) = 3*sqrt(2)."""

import math

import numpy as np
import pytest

from pytv4d_tpu import tv_CPU, tv_GPU


@pytest.fixture
def single_hot():
    img = np.zeros((1, 1, 5, 5))
    img[0, 0, 2, 2] = 1.0
    return img


@pytest.mark.parametrize("tvm", [tv_CPU, tv_GPU], ids=["numpy", "jax"])
def test_analytic_values(single_hot, tvm):
    assert float(tvm.tv_upwind(single_hot)[0]) == pytest.approx(2 + math.sqrt(2), rel=1e-12)
    assert float(tvm.tv_downwind(single_hot)[0]) == pytest.approx(2 + math.sqrt(2), rel=1e-12)
    assert float(tvm.tv_central(single_hot)[0]) == pytest.approx(2.0, rel=1e-12)
    assert float(tvm.tv_hybrid(single_hot)[0]) == pytest.approx(3 * math.sqrt(2), rel=1e-12)


def test_flat_image_inf_convention():
    """Flat regions are nonsmooth points: norms==0 -> inf -> zero subgradient
    (``tv_CPU.py:85-86``)."""
    img = np.full((2, 2, 6, 6), 3.7)
    for scheme in ("upwind", "downwind", "central", "hybrid"):
        tv, G = getattr(tv_CPU, f"tv_{scheme}")(img, reg_time=1.0)
        assert tv == 0.0
        assert np.all(G == 0.0)
        assert np.all(np.isfinite(G))


def test_tv_scales_linearly():
    rng = np.random.default_rng(11)
    img = rng.random((2, 1, 9, 9))
    for scheme in ("upwind", "hybrid"):
        tv1, _ = getattr(tv_CPU, f"tv_{scheme}")(img)
        tv3, _ = getattr(tv_CPU, f"tv_{scheme}")(3.0 * img)
        assert tv3 == pytest.approx(3.0 * tv1, rel=1e-12)
