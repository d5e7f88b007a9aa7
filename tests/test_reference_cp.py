"""The jitted Chambolle-Pock denoiser against the plain NumPy float64
recipe (``pytv4d_tpu.reference``): every scheme and channel configuration,
each TV norm with static masks and ``weight_time`` planes, the fidelity
family with the nonneg projection, and the reduced-precision storage
options (bf16 duals, bf16 primary)."""

import jax.numpy as jnp
import numpy as np
import pytest

from pytv4d_tpu import reference as ref
from pytv4d_tpu.core.config import TVConfig
from pytv4d_tpu.solvers.cp import chambolle_pock

SCHEMES = ("upwind", "downwind", "central", "hybrid")
SHAPE = (4, 3, 8, 12)
CONFIGS = [dict(), dict(reg_time=0.5), dict(reg_time=0.7, reg_z_over_reg=0.3),
           dict(reg_z_over_reg=0.0)]
N_ITER = 12


@pytest.fixture(scope="module")
def x0():
    return np.random.default_rng(0).random(SHAPE)


@pytest.fixture(scope="module")
def mask():
    m = np.zeros((1, 1) + SHAPE[2:], bool)
    m[0, 0, 2:6, 3:9] = True
    return m


@pytest.fixture(scope="module")
def wt():
    return 0.5 + np.random.default_rng(4).random((1, 1) + SHAPE[2:])


def _check(got, want_x, want_loss, rtol=1e-9):
    np.testing.assert_allclose(np.asarray(got.loss), want_loss, rtol=rtol)
    np.testing.assert_allclose(np.asarray(got.x), want_x, rtol=rtol,
                               atol=rtol)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("kw", CONFIGS, ids=["base", "time", "zt", "noz"])
def test_cp_matches_numpy_reference(x0, scheme, kw):
    cfg = TVConfig(scheme=scheme, **kw)
    want_x, want_loss = ref.chambolle_pock(x0, N_ITER, 0.5, cfg)
    got = chambolle_pock(jnp.asarray(x0), n_iter=N_ITER, reg=0.5, cfg=cfg)
    _check(got, want_x, want_loss)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("norm", ["iso", "aniso", "huber"])
def test_cp_mask_weight_matches_numpy(x0, mask, wt, scheme, norm):
    """Plane-shaped static masks and ``weight_time`` planes (the
    reference's ``(1, 1, N, N)`` contract), alone and combined."""
    cfg = TVConfig(scheme=scheme, reg_time=0.7, factor_reg_static=0.3,
                   norm=norm, huber_delta=0.2)
    for ms, w_t in ((mask, None), (None, wt), (mask, wt)):
        want_x, want_loss = ref.chambolle_pock(
            x0, N_ITER, 0.3, cfg, mask_static=ms, weight_time=w_t)
        got = chambolle_pock(
            jnp.asarray(x0), n_iter=N_ITER, reg=0.3, cfg=cfg,
            mask_static=None if ms is None else jnp.asarray(ms),
            weight_time=None if w_t is None else jnp.asarray(w_t))
        _check(got, want_x, want_loss)


@pytest.mark.parametrize("fidelity", ["l2", "l1", "kl"])
@pytest.mark.parametrize("nonneg", [False, True])
def test_cp_fidelity_matches_numpy(x0, fidelity, nonneg):
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    want_x, want_loss = ref.chambolle_pock(
        x0 + 0.1, N_ITER, 0.3, cfg, fidelity=fidelity, fidelity_weight=0.8,
        nonneg=nonneg)
    got = chambolle_pock(jnp.asarray(x0 + 0.1), n_iter=N_ITER, reg=0.3,
                         cfg=cfg, fidelity=fidelity, fidelity_weight=0.8,
                         nonneg=nonneg)
    _check(got, want_x, want_loss)
    if nonneg:
        assert float(got.x.min()) >= 0.0


def test_cp_float32_tracks_numpy(x0):
    """The device storage dtype: f32 iterates stay within f32 round-off
    of the f64 recipe over a 60-iteration horizon."""
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    want_x, want_loss = ref.chambolle_pock(x0 * 100, 60, 5.0, cfg)
    got = chambolle_pock(jnp.asarray(x0 * 100, jnp.float32), n_iter=60,
                         reg=5.0, cfg=cfg)
    assert got.x.dtype == jnp.float32
    _check(got, want_x, want_loss, rtol=1e-4)


def test_cp_bf16_dual_storage(x0):
    """``dual_dtype='bfloat16'`` carries y_D in bf16 between iterations
    (allocated in bf16 on a cold start), computes in f32, returns the dual
    in the input's dtype, and stays close to the f32 solve."""
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    x32 = jnp.asarray(x0 * 100, jnp.float32)
    full = chambolle_pock(x32, n_iter=30, reg=5.0, cfg=cfg)
    half = chambolle_pock(x32, n_iter=30, reg=5.0, cfg=cfg,
                          dual_dtype="bfloat16")
    assert half.state.y_D.dtype == jnp.float32
    assert half.x.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(half.loss), np.asarray(full.loss),
                               rtol=1e-3)
    # a resumed solve keeps the caller's dual dtype
    again = chambolle_pock(x32, n_iter=5, reg=5.0, cfg=cfg,
                           dual_dtype="bfloat16", state=half.state)
    assert again.state.y_D.dtype == jnp.float32
    lean = chambolle_pock(x32, n_iter=30, reg=5.0, cfg=cfg,
                          dual_dtype="bfloat16", return_dual=False)
    assert lean.state.y_D is None
    np.testing.assert_array_equal(np.asarray(lean.x), np.asarray(half.x))


def test_cp_bf16_primary_storage(x0):
    """A bf16 input keeps x and y_A in bf16 between iterations; every
    iteration computes in f32, so the loss series (f32) tracks the f32
    solve to bf16 storage precision."""
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    x32 = jnp.asarray(x0 * 100, jnp.float32)
    full = chambolle_pock(x32, n_iter=30, reg=5.0, cfg=cfg)
    half = chambolle_pock(x32.astype(jnp.bfloat16), n_iter=30, reg=5.0,
                          cfg=cfg, dual_dtype="bfloat16")
    assert half.x.dtype == jnp.bfloat16
    assert half.state.y_A.dtype == jnp.bfloat16
    assert half.loss.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(half.loss), np.asarray(full.loss),
                               rtol=1e-2)
