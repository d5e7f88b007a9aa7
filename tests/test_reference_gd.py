"""The jitted subgradient-descent denoiser and the public
``tv_and_subgrad`` against the plain NumPy float64 reference
(``pytv4d_tpu.reference``): every scheme and channel configuration, each TV
norm with static masks and ``weight_time`` planes, and the nonsmooth
``inf`` convention at flat pixels."""

import jax.numpy as jnp
import numpy as np
import pytest

import pytv4d_tpu as pytv
from pytv4d_tpu import reference as ref
from pytv4d_tpu.core.config import TVConfig
from pytv4d_tpu.ops import tv as tv_mod
from pytv4d_tpu.solvers.gd import subgradient_descent

SCHEMES = ("upwind", "downwind", "central", "hybrid")
SHAPE = (4, 3, 8, 12)
CONFIGS = [dict(), dict(reg_time=0.5), dict(reg_time=0.7, reg_z_over_reg=0.3),
           dict(reg_z_over_reg=0.0)]
N_ITER = 12


@pytest.fixture(scope="module")
def x0():
    return np.random.default_rng(1).random(SHAPE)


@pytest.fixture(scope="module")
def mask():
    m = np.zeros((1, 1) + SHAPE[2:], bool)
    m[0, 0, 1:5, 4:10] = True
    return m


@pytest.fixture(scope="module")
def wt():
    return 0.5 + np.random.default_rng(5).random((1, 1) + SHAPE[2:])


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("kw", CONFIGS, ids=["base", "time", "zt", "noz"])
def test_gd_matches_numpy_reference(x0, scheme, kw):
    cfg = TVConfig(scheme=scheme, **kw)
    want_x, want_loss = ref.subgradient_descent(x0, N_ITER, 0.5, 1e-2, cfg)
    got = subgradient_descent(jnp.asarray(x0), n_iter=N_ITER, reg=0.5,
                              step_size=1e-2, cfg=cfg)
    np.testing.assert_allclose(np.asarray(got.loss), want_loss, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(got.x), want_x, rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("norm", ["iso", "aniso", "huber"])
def test_gd_mask_weight_matches_numpy(x0, mask, wt, scheme, norm):
    """Plane-shaped static masks and ``weight_time`` planes, alone and
    combined, through GD and the public jitted ``tv_and_subgrad``."""
    cfg = TVConfig(scheme=scheme, reg_time=0.7, factor_reg_static=0.3,
                   norm=norm, huber_delta=0.2)
    for ms, w_t in ((mask, None), (None, wt), (mask, wt)):
        want_x, want_loss = ref.subgradient_descent(
            x0, N_ITER, 0.3, 1e-2, cfg, mask_static=ms, weight_time=w_t)
        got = subgradient_descent(
            jnp.asarray(x0), n_iter=N_ITER, reg=0.3, step_size=1e-2,
            cfg=cfg, mask_static=None if ms is None else jnp.asarray(ms),
            weight_time=None if w_t is None else jnp.asarray(w_t))
        np.testing.assert_allclose(np.asarray(got.loss), want_loss,
                                   rtol=1e-10)
        np.testing.assert_allclose(np.asarray(got.x), want_x, rtol=1e-10,
                                   atol=1e-12)

        tv_want, G_want = tv_mod.tv_and_subgrad(
            x0, scheme, mask_static=ms, weight_time=w_t, norm_type=norm,
            huber_delta=0.2, xp=np, **cfg.kwargs())
        tv_got, G_got = pytv.tv_and_subgrad(
            jnp.asarray(x0), scheme, mask_static=ms, weight_time=w_t,
            norm_type=norm, huber_delta=0.2, **cfg.kwargs())
        assert float(tv_got) == pytest.approx(float(tv_want), rel=1e-12)
        np.testing.assert_allclose(np.asarray(G_got), G_want, rtol=1e-10,
                                   atol=1e-12)


def test_flat_image_inf_convention():
    """A flat image has zero TV and a zero subgradient (the norm -> inf
    convention of ``tv_CPU.py:85-86``), on the jitted and NumPy paths."""
    flat = np.full(SHAPE, 3.0)
    tv_got, G_got = pytv.tv_hybrid(jnp.asarray(flat), reg_time=0.5)
    tv_want, G_want = tv_mod.tv_and_subgrad(flat, "hybrid", reg_time=0.5,
                                            xp=np)
    assert float(tv_got) == float(tv_want) == 0.0
    np.testing.assert_array_equal(np.asarray(G_got), G_want)
    assert not np.any(G_want)
