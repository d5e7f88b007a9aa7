"""TV-layer tests: cross-implementation equality (oracle 2), 2D->3D
dimensional consistency (oracle 3), mask handling, and the custom-VJP
subgradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pytv4d_tpu as ptv
from pytv4d_tpu import testing as ptv_testing
from pytv4d_tpu import tv_CPU
from pytv4d_tpu.ops.tv import make_tv, tv_and_subgrad

SCHEMES = ("upwind", "downwind", "central", "hybrid")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_cross_implementation(scheme):
    ptv_testing.test_cross_implementation(scheme, tol=1e-10)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_2d_to_3d(scheme, backend):
    ptv_testing.test_2D_to_3D(scheme, backend)


def test_mask_zeroes_pixels():
    """The reference's ``mask`` kwarg is broken for arrays (SURVEY.md 2.4.2);
    ours must zero masked-out pixels before the TV computation."""
    rng = np.random.default_rng(21)
    img = rng.random((2, 1, 8, 8))
    mask = np.ones_like(img, dtype=bool)
    mask[:, :, :2] = False
    tv_m, G_m = tv_CPU.tv_hybrid(img, mask=mask)
    img_zeroed = np.where(mask, img, 0.0)
    tv_z, G_z = tv_CPU.tv_hybrid(img_zeroed)
    assert tv_m == pytest.approx(tv_z, rel=1e-14)
    np.testing.assert_allclose(G_m, G_z, rtol=1e-14)


def test_return_grad_norms():
    rng = np.random.default_rng(22)
    img = rng.random((2, 2, 8, 8))
    tv, G, norms = tv_CPU.tv_hybrid(img, reg_time=1.0, return_grad_norms=True)
    assert norms.shape == img.shape
    # zero-norm slots have been replaced by +inf (tv_CPU.py:86)
    assert np.all(norms > 0)


def test_make_tv_custom_vjp_matches_subgradient():
    rng = np.random.default_rng(23)
    img = jnp.asarray(rng.random((2, 2, 8, 8)))
    tv_fn = make_tv("hybrid", reg_time=0.5)
    value = tv_fn(img)
    grad = jax.grad(tv_fn)(img)
    tv_want, G_want = tv_and_subgrad(img, "hybrid", reg_time=0.5)
    assert float(value) == pytest.approx(float(tv_want), rel=1e-12)
    np.testing.assert_allclose(np.asarray(grad), np.asarray(G_want), rtol=1e-12)


def test_make_tv_grad_finite_on_flat_image():
    """autodiff of l21 o D would give NaN at flat points; the custom VJP uses
    the reference's inf convention and must stay finite."""
    img = jnp.full((1, 1, 6, 6), 2.0)
    grad = jax.grad(make_tv("hybrid"))(img)
    assert bool(jnp.all(jnp.isfinite(grad)))
    assert bool(jnp.all(grad == 0.0))


def test_jit_cache_reuse():
    """Repeated calls with the same config must not retrace (SURVEY.md 3.2:
    the reference re-pays dispatch per call; we hit the executable cache)."""
    from pytv4d_tpu.ops import api

    img = jnp.asarray(np.random.default_rng(1).random((2, 1, 8, 8)))
    api.tv_and_subgrad(img, "hybrid")
    misses0 = api._tv_jnp._cache_size()
    api.tv_and_subgrad(img, "hybrid")
    assert api._tv_jnp._cache_size() == misses0
