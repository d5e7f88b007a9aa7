"""Operator-level property tests: adjointness (oracle 1, ``pytv/tests.py:111-185``),
boundary/edge cases, rectangular images, and the reference-defect regressions
from SURVEY.md section 2.4."""

import numpy as np
import pytest

from pytv4d_tpu import tv_CPU, tv_operators_CPU, tv_operators_GPU
from pytv4d_tpu.core.schemes import num_channels

SCHEMES = ("upwind", "downwind", "central", "hybrid")


def _adjoint_check(ops, scheme, shape, n=4, tol=1e-10, **kw):
    rng = np.random.default_rng(abs(hash((scheme,) + shape)) % 2**31)
    Nz, M = shape[0], shape[1]
    Nd = num_channels(scheme, Nz, M, kw.get("reg_z_over_reg", 1.0), kw.get("reg_time", 0.0))
    D_fn = getattr(ops, f"D_{scheme}")
    D_T_fn = getattr(ops, f"D_T_{scheme}")
    for _ in range(n):
        X = rng.random(shape)
        Y = rng.random((Nz, Nd, M) + shape[2:])
        lhs = np.sum(np.asarray(D_fn(X, **kw)) * Y)
        rhs = np.sum(np.asarray(D_T_fn(Y, **kw)) * X)
        assert abs(lhs - rhs) / (0.5 * (abs(lhs) + abs(rhs))) < tol


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("ops", [tv_operators_CPU, tv_operators_GPU], ids=["numpy", "jax"])
@pytest.mark.parametrize(
    "shape,kw",
    [
        ((1, 1, 12, 12), {}),                                  # 2D
        ((6, 1, 12, 12), {}),                                  # 3D
        ((6, 1, 12, 12), dict(reg_z_over_reg=0.0)),            # 3D, z off
        ((6, 3, 12, 12), dict(reg_time=0.5)),                  # 4D
        ((6, 2, 12, 12), dict(reg_time=0.5)),                  # 4D, M=2 fallback
        ((2, 4, 12, 12), dict(reg_time=0.5)),                  # Nz=2 fallback
        ((6, 4, 12, 12), dict(reg_z_over_reg=0.3, reg_time=0.7)),
    ],
)
def test_adjointness(scheme, ops, shape, kw):
    tol = 1e-10  # both paths are f64 under the test conftest
    _adjoint_check(ops, scheme, shape, tol=tol, **kw)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_adjointness_with_static_mask(scheme):
    """Adjointness must hold with the static-mask weighting too (the mask
    factor appears symmetrically in D and D_T)."""
    mask = np.zeros((1, 1, 12, 12), dtype=bool)
    mask[0, 0, 3:9, 2:10] = True
    _adjoint_check(
        tv_operators_CPU, scheme, (5, 3, 12, 12),
        reg_time=0.5, mask_static=mask, factor_reg_static=0.3,
    )


@pytest.mark.parametrize("scheme", SCHEMES)
def test_rectangular_images(scheme):
    """Non-square in-plane images work (the reference's to-do, README.md:259)."""
    _adjoint_check(tv_operators_CPU, scheme, (3, 2, 10, 16), reg_time=0.5)
    rng = np.random.default_rng(3)
    img = rng.random((2, 1, 8, 24))
    tv, G = getattr(tv_CPU, f"tv_{scheme}")(img)
    assert np.isfinite(tv) and G.shape == img.shape


def test_central_nz2_does_not_crash():
    """SURVEY.md 2.4.1: reference CPU D_central raises IndexError at Nz==2;
    we follow the working GPU gate (Nz>1) with the upwind fallback."""
    rng = np.random.default_rng(5)
    img = rng.random((2, 1, 8, 8))
    D = tv_operators_CPU.D_central(img)
    assert D.shape == (2, 3, 1, 8, 8)
    # fallback = upwind z channel, scaled by the central 1/2 normalization
    D_up = tv_operators_CPU.D_upwind(img)
    np.testing.assert_allclose(D[:, 2], D_up[:, 2] / 2.0, rtol=1e-14)


def test_d_t_channel_count_validation():
    rng = np.random.default_rng(6)
    bad = rng.random((4, 3, 2, 8, 8))  # hybrid with Nz=4 expects 6 or 8 channels
    with pytest.raises(ValueError, match="channels"):
        tv_operators_CPU.D_T_hybrid(bad)


def test_dtype_preserved():
    rng = np.random.default_rng(7)
    img32 = rng.random((2, 1, 8, 8)).astype(np.float32)
    assert tv_operators_CPU.D_upwind(img32).dtype == np.float32
    assert np.asarray(tv_operators_GPU.D_upwind(img32)).dtype == np.float32


def test_boundary_slots_are_zero():
    """One-sided boundary convention (tv_operators_CPU.py:115-127)."""
    rng = np.random.default_rng(8)
    img = rng.random((3, 2, 8, 8))
    D = tv_operators_CPU.D_hybrid(img, reg_time=1.0)
    # fwd channels: last slot zero; bwd channels: first slot zero
    assert np.all(D[:, 0, :, -1, :] == 0)   # row fwd
    assert np.all(D[:, 1, :, :, -1] == 0)   # col fwd
    assert np.all(D[:, 2, :, 0, :] == 0)    # row bwd
    assert np.all(D[:, 3, :, :, 0] == 0)    # col bwd
    assert np.all(D[-1, 4] == 0)            # z fwd
    assert np.all(D[0, 5] == 0)             # z bwd
    assert np.all(D[:, 6, -1] == 0)         # t fwd
    assert np.all(D[:, 7, 0] == 0)          # t bwd


def test_weight_time_matrix_adjoint_and_semantics():
    """The reference's to-do (README.md:258): full per-pixel time-weight
    matrix. Must (a) keep exact adjointness for arbitrary weight fields,
    (b) reduce to the mask_static path for (1,1,N,N)-uniform masks."""
    from pytv4d_tpu.ops import operators as O

    rng = np.random.default_rng(12)
    shape = (4, 3, 10, 10)
    W = rng.random((4, 3, 10, 10)) + 0.5
    kw = dict(reg_time=0.7, weight_time=W)
    Nd = num_channels("hybrid", 4, 3, 1.0, 0.7)
    X = rng.random(shape)
    Y = rng.random((4, Nd, 3, 10, 10))
    lhs = np.sum(Y * np.asarray(O.D(X, "hybrid", xp=np, **kw)))
    rhs = np.sum(np.asarray(O.D_T(Y, "hybrid", xp=np, **kw)) * X)
    assert abs(lhs - rhs) / abs(lhs) < 1e-12

    # equivalence with mask_static for a z/t-uniform boolean mask
    mask = np.zeros((1, 1, 10, 10), bool)
    mask[0, 0, 2:7, 3:9] = True
    factor = 0.3
    W_eq = np.where(mask, np.sqrt(factor), 1.0)
    D_mask = O.D(X, "hybrid", reg_time=0.7, mask_static=mask,
                 factor_reg_static=factor, xp=np)
    D_w = O.D(X, "hybrid", reg_time=0.7, weight_time=W_eq, xp=np)
    np.testing.assert_allclose(D_w, D_mask, rtol=1e-14)

    # tv layer accepts it too
    from pytv4d_tpu.ops.tv import tv_and_subgrad
    tv, G = tv_and_subgrad(X, "hybrid", reg_time=0.7, weight_time=W, xp=np)
    assert np.isfinite(tv) and G.shape == X.shape
