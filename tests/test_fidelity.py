"""Data-fidelity family (solvers/fidelity.py): exact conjugate-prox checks
via the Moreau decomposition against independently-derived primal proxes,
l2 bit-parity with the historical path, and solver-level behavior (loss
decrease, noise-model selectivity, nonnegativity)."""

import jax.numpy as jnp
import numpy as np
import pytest

from pytv4d_tpu.models.ct import cp_reconstruct, radon
from pytv4d_tpu.solvers.fidelity import (
    FIDELITIES,
    fidelity_dual_prox,
    fidelity_loss,
)
from pytv4d_tpu.solvers.inverse import cp_inverse
from pytv4d_tpu.solvers.tgv import tgv_inverse


def _primal_prox(v, b, lam, fidelity, w):
    """prox_{lam F}(v), each derived independently of fidelity_dual_prox:
    l2 = weighted resolvent, l1 = soft threshold around b, kl = positive
    root of the pointwise quadratic u^2 + (lam w - v) u - lam w b = 0."""
    if fidelity == "l2":
        return (v + lam * w * b) / (1.0 + lam * w)
    if fidelity == "l1":
        d = v - b
        return b + np.sign(d) * np.maximum(np.abs(d) - lam * w, 0.0)
    t = v - lam * w
    return 0.5 * (t + np.sqrt(t * t + 4.0 * lam * w * b))


@pytest.mark.parametrize("fidelity", FIDELITIES)
@pytest.mark.parametrize("weight", [1.0, 0.35, "array"])
def test_dual_prox_moreau_identity(fidelity, weight):
    """prox_{sigma F*}(q) == q - sigma prox_{F/sigma}(q/sigma) pointwise
    (Moreau), for scalar and per-measurement weights."""
    rng = np.random.default_rng(3)
    n = 257
    y = rng.standard_normal(n)
    Ax = rng.standard_normal(n)
    b = np.abs(rng.standard_normal(n))  # kl needs b >= 0
    w = rng.uniform(0.2, 2.0, n) if weight == "array" else weight
    for sigma in (0.07, 1.0, 13.0):
        got = np.asarray(
            fidelity_dual_prox(jnp.asarray(y), jnp.asarray(Ax),
                               jnp.asarray(b), sigma, fidelity, w)
        )
        q = y + sigma * Ax
        want = q - sigma * _primal_prox(q / sigma, b, 1.0 / sigma,
                                        fidelity, w)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_kl_prox_stays_in_conjugate_domain():
    """F* for the Poisson term is finite only on p < weight — the
    closed-form prox must land there for extreme inputs."""
    y = jnp.asarray([1e6, -1e6, 0.0, 5.0])
    Ax = jnp.asarray([1e5, 0.0, 0.0, -3.0])
    b = jnp.asarray([0.0, 7.0, 0.0, 2.0])
    p = np.asarray(fidelity_dual_prox(y, Ax, b, 2.0, "kl", 1.5))
    assert np.all(p <= 1.5)


def test_fidelity_loss_values():
    Ax = jnp.asarray([2.0, 0.5, 1.0])
    b = jnp.asarray([1.0, 1.0, 0.0])
    assert float(fidelity_loss(Ax, b, "l2")) == pytest.approx(
        0.5 * (1.0 + 0.25 + 1.0))
    assert float(fidelity_loss(Ax, b, "l1", 2.0)) == pytest.approx(
        2.0 * (1.0 + 0.5 + 1.0))
    # kl: sum(Ax - b + b log(b/Ax)); b=0 bin contributes Ax
    want = (2.0 - 1.0 + np.log(1 / 2.0)) + (0.5 - 1.0 + np.log(1 / 0.5)) + 1.0
    assert float(fidelity_loss(Ax, b, "kl")) == pytest.approx(want)
    # zero exactly at a perfect fit
    assert float(fidelity_loss(b, b, "kl")) == pytest.approx(0.0, abs=1e-12)


def test_validation_errors():
    b = jnp.ones((1, 1, 8, 8))
    A = lambda x: x
    with pytest.raises(ValueError, match="fidelity must be one of"):
        cp_inverse(A, b, b.shape, n_iter=1, fidelity="huber")
    with pytest.raises(ValueError, match="fidelity_weight must be positive"):
        cp_inverse(A, b, b.shape, n_iter=1, fidelity_weight=0.0)
    with pytest.raises(ValueError, match="nonnegative data"):
        cp_inverse(A, -b, b.shape, n_iter=1, fidelity="kl")


def test_l2_default_bit_parity():
    """fidelity='l2', weight=1, nonneg=False must be bit-identical to the
    pre-fidelity iteration (pure refactor on the default path)."""
    rng = np.random.default_rng(0)
    shape = (1, 2, 16, 16)
    b = jnp.asarray(rng.random(shape))
    A = lambda x: 0.5 * (x + jnp.roll(x, 1, axis=-1))

    res = cp_inverse(A, b, shape, n_iter=25, reg=0.1, op_norm=1.0)
    ref = cp_inverse(A, b, shape, n_iter=25, reg=0.1, op_norm=1.0,
                     fidelity="l2", fidelity_weight=1.0)
    assert np.array_equal(np.asarray(res.x), np.asarray(ref.x))
    assert np.array_equal(np.asarray(res.loss), np.asarray(ref.loss))


@pytest.mark.parametrize("fidelity", ["l1", "kl"])
@pytest.mark.parametrize("precond", [False, True])
def test_cp_inverse_losses_decrease(fidelity, precond):
    rng = np.random.default_rng(1)
    shape = (1, 1, 24, 24)
    truth = np.zeros(shape, np.float64)
    truth[0, 0, 6:18, 6:18] = 2.0
    b = jnp.asarray(truth + 0.05 * rng.standard_normal(shape) + 2.0)
    A = lambda x: x
    res = cp_inverse(A, b, shape, n_iter=120, reg=0.5, fidelity=fidelity,
                     precond=precond, nonneg=True,
                     op_norm=None if precond else 1.0)
    loss = np.asarray(res.loss)
    assert np.all(np.isfinite(loss))
    assert loss[-1] < loss[4]
    assert float(jnp.min(res.x)) >= 0.0


def test_l1_beats_l2_on_salt_and_pepper():
    """The TV-L1 model rejects impulsive outliers that least squares
    smears: reconstruction error on salt-and-pepper noise must be clearly
    lower with fidelity='l1'."""
    rng = np.random.default_rng(7)
    shape = (1, 1, 32, 32)
    truth = np.zeros(shape, np.float64)
    truth[0, 0, 8:24, 8:24] = 1.0
    noisy = truth.copy()
    flips = rng.random(shape) < 0.15
    noisy[flips] = rng.choice([0.0, 3.0], size=int(flips.sum()))
    A = lambda x: x
    common = dict(n_iter=400, op_norm=1.0)
    x_l1 = cp_inverse(A, jnp.asarray(noisy), shape, reg=0.9, fidelity="l1",
                      **common).x
    x_l2 = cp_inverse(A, jnp.asarray(noisy), shape, reg=0.25, **common).x
    err_l1 = float(jnp.sqrt(jnp.mean((x_l1 - truth) ** 2)))
    err_l2 = float(jnp.sqrt(jnp.mean((x_l2 - truth) ** 2)))
    assert err_l1 < 0.6 * err_l2


def test_kl_ct_poisson_counts():
    """Poisson-count CT: KL fidelity with per-ray weighting reconstructs a
    phantom from noisy counts; loss decreases and the result is
    nonnegative and close to truth."""
    rng = np.random.default_rng(5)
    shape = (1, 1, 32, 32)
    truth = np.zeros(shape, np.float64)
    truth[0, 0, 10:22, 10:22] = 0.04
    truth[0, 0, 14:18, 14:18] = 0.08
    angles = jnp.linspace(0, np.pi, 24, endpoint=False)
    sino_clean = radon(jnp.asarray(truth), angles)
    # photon-count model: counts ~ Poisson(I0 exp(-line integral)); the
    # linearized KL problem fits A x to the post-log sinogram with weights
    # proportional to the counts (higher counts = more trusted rays)
    I0 = 5e4
    counts = rng.poisson(I0 * np.exp(-np.asarray(sino_clean)))
    counts = np.maximum(counts, 1)
    # clamp the post-log data at 0: Poisson overshoot past I0 would give
    # (unphysical) negative line integrals, which 'kl' rejects by contract
    b = jnp.asarray(np.maximum(-np.log(counts / I0), 0.0))
    res = cp_reconstruct(
        b, angles, shape, n_iter=150, reg=5e-4, fidelity="kl",
        fidelity_weight=jnp.asarray(counts / counts.mean()),
        nonneg=True, precond=True,
    )
    loss = np.asarray(res.loss)
    assert np.all(np.isfinite(loss))
    assert loss[-1] < loss[2]
    err = float(jnp.sqrt(jnp.mean((res.x - truth) ** 2)))
    assert err < 0.25 * float(np.sqrt((truth ** 2).mean()))
    assert float(jnp.min(res.x)) >= 0.0


def test_cp_inverse_kl_traces_under_vmap():
    """Data-dependent validation must not break tracing: batching
    cp_inverse over sinograms with jax.vmap works when op_norm/A_T are
    supplied (the checks are skipped for traced b/weight)."""
    import jax

    shape = (1, 1, 8, 8)
    rng = np.random.default_rng(4)
    batch = jnp.asarray(rng.random((3,) + shape))

    def solve(bi):
        return cp_inverse(lambda x: x, bi, shape, A_T=lambda y: y,
                          n_iter=5, reg=0.1, op_norm=1.0,
                          fidelity="kl", nonneg=True).x

    xs = jax.vmap(solve)(batch)
    assert xs.shape == (3,) + shape
    assert np.all(np.isfinite(np.asarray(xs)))


@pytest.mark.parametrize("fidelity,nonneg",
                         [("l1", False), ("kl", True), ("l2", True)])
def test_denoiser_fused_fidelity_matches_jnp(fidelity, nonneg):
    """The f32 CP denoiser (f32 storage, f32 compute) tracks the f64 solve
    for TV-L1 / Poisson / nonneg."""
    from pytv4d_tpu.core.config import TVConfig
    from pytv4d_tpu.solvers.cp import chambolle_pock

    rng = np.random.default_rng(11)
    x0 = jnp.asarray(rng.random((2, 2, 16, 128)) + 0.1)
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    kw = dict(n_iter=15, reg=0.3, cfg=cfg, fidelity=fidelity,
              fidelity_weight=0.8, nonneg=nonneg)
    a = chambolle_pock(x0, **kw)
    b = chambolle_pock(x0.astype(jnp.float32), **kw)
    np.testing.assert_allclose(np.asarray(b.loss), np.asarray(a.loss),
                               rtol=1e-4)
    np.testing.assert_allclose(np.asarray(b.x), np.asarray(a.x),
                               atol=1e-4, rtol=1e-4)
    if nonneg:
        assert float(b.x.min()) >= 0.0


def test_denoiser_fused_fidelity_with_static_mask():
    """fidelity='l1' composes with the reference's static-mask feature
    (the t-channel multiplier is orthogonal to the fidelity switch) — the
    f32 solve tracks the f64 one."""
    from pytv4d_tpu.core.config import TVConfig
    from pytv4d_tpu.solvers.cp import chambolle_pock

    rng = np.random.default_rng(13)
    x0 = jnp.asarray(rng.random((2, 3, 16, 128)))
    mask = np.zeros((1, 1, 16, 128), bool)
    mask[..., 4:10, 30:90] = True
    cfg = TVConfig(scheme="upwind", reg_time=1.0, factor_reg_static=0.5)
    kw = dict(n_iter=12, reg=0.3, cfg=cfg, mask_static=jnp.asarray(mask),
              fidelity="l1", fidelity_weight=1.5)
    a = chambolle_pock(x0, **kw)
    b = chambolle_pock(x0.astype(jnp.float32), **kw)
    np.testing.assert_allclose(np.asarray(b.loss), np.asarray(a.loss),
                               rtol=1e-4)
    np.testing.assert_allclose(np.asarray(b.x), np.asarray(a.x),
                               atol=1e-4, rtol=1e-4)


def test_denoiser_fidelity_validation():
    from pytv4d_tpu.solvers.cp import chambolle_pock

    x = jnp.ones((1, 1, 16, 128), jnp.float32)
    with pytest.raises(ValueError, match="fidelity must be one of"):
        chambolle_pock(x, n_iter=1, fidelity="tv")
    with pytest.raises(ValueError, match="positive"):
        chambolle_pock(x, n_iter=1, fidelity_weight=-1.0)
    # the kl data check runs EAGERLY (outside the jit boundary) — negative
    # pixels must raise, not silently produce NaNs in the conjugate prox
    with pytest.raises(ValueError, match="nonnegative data"):
        chambolle_pock(-x, n_iter=1, fidelity="kl")


def test_gap_criterion_guards():
    """criterion='gap' guards: the DENOISING gap certifies l2 only (the
    inverse gap supports all three fidelities); an inverse-solver state
    without a prior set gets the pd_gap_inverse guidance."""
    import functools

    from pytv4d_tpu.solvers import cp_inverse, run_until_converged
    from pytv4d_tpu.solvers.cp import chambolle_pock

    x = jnp.ones((1, 1, 8, 8))
    with pytest.raises(ValueError, match="l2-fidelity"):
        run_until_converged(chambolle_pock, x, criterion="gap",
                            fidelity="l1", reg=1.0)
    solver = functools.partial(cp_inverse, lambda v: v, vol_shape=x.shape,
                               op_norm=1.0, reg=0.1)
    with pytest.raises(ValueError, match="x_box"):
        run_until_converged(solver, x, criterion="gap", chunk=5,
                            max_iter=10)
    # with the prior set, the inverse gap criterion runs (and on the
    # identity operator the denoising-equivalent problem certifies fast)
    res = run_until_converged(solver, x, criterion="gap", chunk=25,
                              max_iter=500, tol=1e-3, gap_x_box=2.0)
    assert len(res.loss) <= 500


def test_inverse_runner_cache_shared_across_regs():
    """cp_inverse's jitted runner is shared across reg values (reg is a
    traced scalar) — a reg sweep must not build one executable per reg."""
    from pytv4d_tpu.solvers.inverse import _make_inverse_run, cp_inverse

    _make_inverse_run.cache_clear()
    b = jnp.ones((1, 1, 8, 8))
    A = lambda v: v
    A_T = lambda v: v
    for reg in (0.1, 0.237, 1.7):
        cp_inverse(A, b, b.shape, A_T=A_T, n_iter=2, reg=reg, op_norm=1.0)
    info = _make_inverse_run.cache_info()
    assert info.misses == 1 and info.hits == 2


def test_sharded_fused_cp_fidelity_tracks_unsharded():
    """fidelity='l1' + nonneg ride the shard_map CP solver (pointwise
    updates — sharding-invariant), tracking the unsharded solver."""
    import jax

    from pytv4d_tpu.core.config import TVConfig
    from pytv4d_tpu.parallel.mesh import make_mesh, shard_volume
    from pytv4d_tpu.solvers.cp import chambolle_pock, init_state

    rng = np.random.default_rng(21)
    shape = (8, 4, 16, 16)
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    noisy = jnp.asarray(rng.random(shape) + 3.0, jnp.float32)
    mesh = make_mesh(z=4, t=2, devices=jax.devices()[:8])

    ref = chambolle_pock(noisy, n_iter=20, reg=0.4, cfg=cfg,
                         fidelity="l1", nonneg=True)
    st = init_state(noisy, cfg)

    # the jnp shard_map path carries the same family
    from pytv4d_tpu.parallel import d_volume_sharding, make_sharded_cp_solver

    solve_jnp = make_sharded_cp_solver(mesh, cfg, shape, reg=0.4,
                                       n_iter=20, fidelity="l1",
                                       nonneg=True)
    xj, _, _, lj = solve_jnp(
        shard_volume(noisy, mesh), shard_volume(st.x, mesh),
        shard_volume(st.y_A, mesh),
        jax.device_put(st.y_D, d_volume_sharding(mesh)),
    )
    np.testing.assert_allclose(np.asarray(lj), np.asarray(ref.loss),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(xj), np.asarray(ref.x),
                               atol=1e-5, rtol=1e-4)


def test_tgv_inverse_fidelity_smoke():
    rng = np.random.default_rng(2)
    shape = (1, 1, 24, 24)
    ramp = np.broadcast_to(
        np.linspace(0, 1, 24)[None, None, :, None], shape).copy()
    noisy = ramp.copy()
    flips = rng.random(shape) < 0.1
    noisy[flips] = rng.choice([0.0, 2.0], size=int(flips.sum()))
    res = tgv_inverse(lambda x: x, jnp.asarray(noisy), shape, n_iter=200,
                      alpha1=0.6, alpha0=1.2, fidelity="l1", nonneg=True,
                      op_norm=1.0)
    loss = np.asarray(res.loss)
    assert np.all(np.isfinite(loss))
    assert loss[-1] < loss[4]
    assert float(jnp.min(res.x)) >= 0.0
    err = float(jnp.sqrt(jnp.mean((res.x - ramp) ** 2)))
    assert err < 0.15


def test_fidelity_conjugate_fenchel_young():
    """F(v) + F*(y) >= <y, v> for all (v, y), equality at y = grad F(v) —
    the conjugates must pair with the reported fidelity_loss forms."""
    from pytv4d_tpu.solvers.fidelity import fidelity_conjugate, fidelity_loss

    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.random((4, 8)) + 0.1)
    v = jnp.asarray(rng.random((4, 8)) + 0.2)
    w = 1.7
    for fid in ("l2", "l1", "kl"):
        y_raw = jnp.asarray(rng.standard_normal((4, 8)))
        y, fstar = fidelity_conjugate(y_raw, b, fid, w)
        lhs = float(fidelity_loss(v, b, fid, w) + fstar)
        rhs = float(jnp.sum(y * v))
        assert lhs >= rhs - 1e-9 * abs(lhs), fid
        # equality at the subgradient: l2 grad = w (v - b)
        if fid == "l2":
            yg, fg = fidelity_conjugate(w * (v - b), b, fid, w)
            eq = float(fidelity_loss(v, b, fid, w) + fg - jnp.sum(yg * v))
            assert abs(eq) < 1e-9
        if fid == "kl":
            # Csiszar primal: grad = w (1 - b / v)
            yg, fg = fidelity_conjugate(w * (1.0 - b / v), b, fid, w)
            eq = float(fidelity_loss(v, b, fid, w) + fg - jnp.sum(yg * v))
            assert abs(eq) < 1e-8
    # per-measurement array weight with dead rows (w = 0)
    wv = jnp.asarray(rng.random((4, 8)))
    wv = wv.at[0].set(0.0)
    y, fstar = fidelity_conjugate(jnp.asarray(rng.standard_normal((4, 8))),
                                  b, "l2", wv)
    assert float(jnp.max(jnp.abs(y[0]))) == 0.0
    assert np.isfinite(float(fstar))
