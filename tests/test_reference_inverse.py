"""``cp_inverse`` against the plain NumPy float64 recipe
(``pytv4d_tpu.reference``) on a dense nonnegative forward operator: every
scheme, the TV norms, the fidelity family, nonneg with per-measurement
weights, resume, bf16 dual storage and loss sampling."""

import jax.numpy as jnp
import numpy as np
import pytest

from pytv4d_tpu import reference as ref
from pytv4d_tpu.core.config import TVConfig
from pytv4d_tpu.solvers.inverse import cp_inverse

VOL = (2, 2, 6, 6)
N_ITER = 15


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    n = int(np.prod(VOL))
    M = rng.random((100, n)) / n
    truth = rng.random(VOL)
    b = M @ truth.ravel() + 0.01 * rng.random(100)
    Mj = jnp.asarray(M)
    return dict(
        M=M, b=b, op_norm=float(np.linalg.norm(M, 2)),
        A=lambda v: Mj @ v.reshape(-1),
        A_np=lambda v: M @ v.reshape(-1),
        A_T_np=lambda y: (M.T @ y).reshape(VOL),
    )


def _compare(data, cfg, rtol=1e-9, **kw):
    want_x, want_loss = ref.cp_inverse(
        data["A_np"], data["A_T_np"], data["b"], VOL, N_ITER, 0.02, cfg,
        data["op_norm"], **kw)
    got = cp_inverse(data["A"], jnp.asarray(data["b"]), VOL, n_iter=N_ITER,
                     reg=0.02, cfg=cfg, op_norm=data["op_norm"], **kw)
    np.testing.assert_allclose(np.asarray(got.loss), want_loss, rtol=rtol)
    np.testing.assert_allclose(np.asarray(got.x), want_x, rtol=rtol,
                               atol=rtol)
    return got


@pytest.mark.parametrize("scheme", ["upwind", "downwind", "central",
                                    "hybrid"])
def test_inverse_matches_numpy_schemes(data, scheme):
    _compare(data, TVConfig(scheme=scheme, reg_time=0.5))


@pytest.mark.parametrize("norm", ["aniso", "huber"])
def test_inverse_matches_numpy_norms(data, norm):
    _compare(data, TVConfig(scheme="hybrid", reg_time=0.5, norm=norm,
                            huber_delta=0.05))


@pytest.mark.parametrize("fidelity", ["l1", "kl"])
def test_inverse_matches_numpy_fidelities(data, fidelity):
    _compare(data, TVConfig(scheme="hybrid", reg_time=0.5),
             fidelity=fidelity, fidelity_weight=0.7)


def test_inverse_nonneg_and_weight(data):
    w = 0.5 + np.random.default_rng(8).random(data["b"].shape)
    got = _compare(data, TVConfig(scheme="hybrid", reg_time=0.5),
                   nonneg=True, fidelity_weight=w)
    assert float(got.x.min()) >= 0.0


def test_inverse_resume_matches_one_shot(data):
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    kw = dict(reg=0.02, cfg=cfg, op_norm=data["op_norm"])
    b = jnp.asarray(data["b"])
    full = cp_inverse(data["A"], b, VOL, n_iter=2 * N_ITER, **kw)
    a = cp_inverse(data["A"], b, VOL, n_iter=N_ITER, **kw)
    c = cp_inverse(data["A"], b, VOL, n_iter=N_ITER, state=a.state, **kw)
    np.testing.assert_allclose(np.asarray(c.x), np.asarray(full.x),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.concatenate([a.loss, c.loss]),
                               np.asarray(full.loss), rtol=1e-12)


def test_inverse_bf16_dual_close(data):
    """bf16 TV-dual storage: the dual is carried in bf16, returned in the
    data's dtype, and the f32 solve is tracked to bf16 precision."""
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    b = jnp.asarray(data["b"], jnp.float32)
    M32 = jnp.asarray(data["M"], jnp.float32)

    def A(v):
        return M32 @ v.reshape(-1)

    kw = dict(n_iter=40, reg=0.02, cfg=cfg, op_norm=data["op_norm"])
    full = cp_inverse(A, b, VOL, **kw)
    half = cp_inverse(A, b, VOL, dual_dtype="bfloat16", **kw)
    assert half.state.y_D.dtype == jnp.float32
    assert half.x.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(half.loss), np.asarray(full.loss),
                               rtol=2e-2)
    np.testing.assert_allclose(np.asarray(half.x), np.asarray(full.x),
                               atol=2e-2 * float(jnp.max(full.x)))


def test_loss_every_samples_chunk_ends(data):
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    kw = dict(n_iter=N_ITER, reg=0.02, cfg=cfg, op_norm=data["op_norm"])
    b = jnp.asarray(data["b"])
    full = cp_inverse(data["A"], b, VOL, **kw)
    sampled = cp_inverse(data["A"], b, VOL, loss_every=5, **kw)
    assert sampled.loss.shape == (3,)
    np.testing.assert_allclose(np.asarray(sampled.loss),
                               np.asarray(full.loss)[4::5], rtol=1e-12)
    np.testing.assert_allclose(np.asarray(sampled.x), np.asarray(full.x),
                               rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="divisor"):
        cp_inverse(data["A"], b, VOL, loss_every=4, **kw)


def test_precond_sums_require_precond(data):
    b = jnp.asarray(data["b"])
    with pytest.raises(ValueError, match="precond_sums requires"):
        cp_inverse(data["A"], b, VOL, n_iter=2, op_norm=1.0,
                   precond_sums=(b, jnp.ones(VOL)))
    with pytest.raises(ValueError, match="precond_scale requires"):
        cp_inverse(data["A"], b, VOL, n_iter=2, op_norm=1.0,
                   precond_scale=2.0)
