"""CT projector + TV-regularized reconstruction tests: projector adjointness
(the same oracle as the TV operators), geometry sanity, and recon quality on
a phantom."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytv4d_tpu.core.config import TVConfig
from pytv4d_tpu.models.ct import (
    cp_reconstruct,
    estimate_op_norm,
    make_projector,
    radon,
)
from pytv4d_tpu.utils import synthetic_phantom


def test_radon_shapes_and_mass():
    img = np.zeros((1, 1, 32, 32), np.float32)
    img[0, 0, 8:24, 8:24] = 1.0
    angles = jnp.linspace(0, np.pi, 12, endpoint=False)
    sino = radon(img, angles)
    assert sino.shape == (1, 1, 12, 32)
    # each projection integrates the image mass (up to edge interpolation)
    mass = float(img.sum())
    sums = np.asarray(sino.sum(axis=-1))[0, 0]
    np.testing.assert_allclose(sums, mass, rtol=2e-2)


def test_projector_adjointness():
    """<y, A x> == <A_T y, x> to fp precision (jax.linear_transpose)."""
    shape = (2, 2, 24, 24)
    angles = jnp.linspace(0, np.pi, 10, endpoint=False)
    A, A_T = make_projector(shape, angles, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random(shape))
    y = jnp.asarray(rng.random((2, 2, 10, 24)))
    lhs = float(jnp.sum(y * A(x)))
    rhs = float(jnp.sum(A_T(y) * x))
    assert abs(lhs - rhs) / abs(lhs) < 1e-12


def test_per_frame_angles():
    """Dynamic CT: distinct angle sets per time frame (the reference paper's
    setting)."""
    img = np.random.default_rng(1).random((1, 3, 16, 16)).astype(np.float32)
    angles = jnp.stack([jnp.linspace(0, np.pi, 5, endpoint=False) + d
                        for d in (0.0, 0.1, 0.2)])
    sino = radon(img, angles)
    assert sino.shape == (1, 3, 5, 16)
    # frame m must equal projecting frame m with its own angles
    solo = radon(img[:, 1:2], angles[1])
    np.testing.assert_allclose(np.asarray(sino[:, 1:2]), np.asarray(solo),
                               rtol=1e-6)


def test_op_norm_estimate_positive():
    shape = (1, 1, 16, 16)
    angles = jnp.linspace(0, np.pi, 8, endpoint=False)
    A, A_T = make_projector(shape, angles)
    n = float(estimate_op_norm(A, A_T, shape))
    assert n > 1.0  # projector sums N samples per ray


def test_cp_reconstruction_recovers_phantom():
    truth2d = synthetic_phantom(32).astype(np.float32)
    truth = truth2d[None, None] / 255.0
    angles = jnp.linspace(0, np.pi, 40, endpoint=False)
    sino = radon(truth, angles)
    res = cp_reconstruct(sino, angles, truth.shape, n_iter=80, reg=0.02,
                         cfg=TVConfig(scheme="hybrid"))
    loss = np.asarray(res.loss)
    assert loss[-1] < 0.05 * loss[0]
    x = np.asarray(res.x)[0, 0]
    t = np.asarray(truth)[0, 0]
    corr = np.corrcoef(x.ravel(), t.ravel())[0, 1]
    assert corr > 0.95, f"reconstruction correlation {corr:.3f}"


def _disk_phantom(N: int, dtype=np.float32):
    """Phantom masked to a centered disk — FBP/FDK assume compact support
    inside the scan FOV (an object filling the frame has truncated
    projections -> cupping, regardless of filter quality)."""
    base = synthetic_phantom(N).astype(dtype) / 255.0
    yy, xx = np.meshgrid(np.arange(N) - (N - 1) / 2,
                         np.arange(N) - (N - 1) / 2, indexing="ij")
    return base * ((yy ** 2 + xx ** 2) <= (0.45 * N) ** 2)


def test_fbp_reconstructs_well_sampled():
    """FBP on densely-sampled data recovers the phantom (classical result)
    at the CORRECT absolute scale (bandlimited Ram-Lak — the exact
    real-space taps, not a sampled |f|), and warm-starting the TV solver
    with it speeds convergence."""
    from pytv4d_tpu.models.ct import fbp

    truth = _disk_phantom(48)[None, None]
    angles = jnp.linspace(0, np.pi, 90, endpoint=False)
    sino = radon(truth, angles)
    rec = fbp(sino, angles)
    assert rec.shape == truth.shape
    corr = np.corrcoef(np.asarray(rec).ravel(), truth.ravel())[0, 1]
    assert corr > 0.97, corr
    scale = (np.percentile(np.asarray(rec), 95)
             / np.percentile(truth, 95))
    assert 0.95 < scale < 1.05, scale  # absolute calibration

    # apodized variants run and stay close (smoother, slightly softer)
    for fn in ("shepp-logan", "cosine", "hann", "hamming"):
        rec_w = fbp(sino, angles, filter_name=fn)
        corr_w = np.corrcoef(np.asarray(rec_w).ravel(), truth.ravel())[0, 1]
        assert corr_w > 0.95, (fn, corr_w)
    with pytest.raises(ValueError, match="filter"):
        fbp(sino, angles, filter_name="nope")

    cold = cp_reconstruct(sino, angles, truth.shape, n_iter=20, reg=0.01)
    warm = cp_reconstruct(sino, angles, truth.shape, n_iter=20, reg=0.01,
                          x_init=rec)
    assert float(warm.loss[-1]) < float(cold.loss[-1])


def test_fbp_per_frame_angles():
    from pytv4d_tpu.models.ct import fbp

    img = np.random.default_rng(3).random((1, 2, 16, 16)).astype(np.float32)
    angles = jnp.stack([jnp.linspace(0, np.pi, 8, endpoint=False),
                        jnp.linspace(0, np.pi, 8, endpoint=False) + 0.05])
    rec = fbp(radon(img, angles), angles)
    assert rec.shape == img.shape


def test_fan_projector_adjointness():
    """Fan-beam A/A_T pass the same dot-product oracle as the parallel pair
    and the TV operators (SURVEY.md section 4 oracle 1)."""
    from pytv4d_tpu.models.ct import FanBeamGeometry, make_fan_projector

    shape = (2, 2, 24, 24)
    angles = jnp.linspace(0, 2 * np.pi, 10, endpoint=False)
    geom = FanBeamGeometry(source_dist=60.0, det_dist=30.0)
    A, A_T = make_fan_projector(shape, angles, geom, dtype=jnp.float64)
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.random(shape))
    y = jnp.asarray(rng.random((2, 2, 10, 24)))
    lhs = float(jnp.sum(y * A(x)))
    rhs = float(jnp.sum(A_T(y) * x))
    assert abs(lhs - rhs) / abs(lhs) < 1e-12


def test_fan_parallel_limit_analytic():
    """As source_dist -> inf the fan opens to parallel beam.  Oracle: an
    OFF-CENTER Gaussian blob (off-center so the detector-axis/ray-direction
    conventions are actually exercised) whose line integrals are analytic:
    ``sigma*sqrt(2*pi) * exp(-(s - <p, u(theta)>)^2 / (2 sigma^2))``.
    A rough (random) phantom is the wrong oracle here: the two projectors
    sample the same C0 bilinear surface at different quadrature phases, so
    obliques legitimately differ by a few percent on non-smooth data."""
    from pytv4d_tpu.models.ct import FanBeamGeometry, radon_fan

    N, sig = 32, 4.0
    c = (N - 1) / 2
    p = np.array([4.0, -6.0])  # blob center offset (rows, cols)
    rr, cc = np.meshgrid(np.arange(N) - c, np.arange(N) - c, indexing="ij")
    blob = np.exp(-((rr - p[0]) ** 2 + (cc - p[1]) ** 2) / (2 * sig**2))
    vol = jnp.asarray(blob[None, None], jnp.float64)
    angles = np.linspace(0, np.pi, 6, endpoint=False)
    par = np.asarray(radon(vol, jnp.asarray(angles)))
    geom = FanBeamGeometry(source_dist=1e6, det_dist=0.0)
    fan = np.asarray(radon_fan(vol, jnp.asarray(angles), geom))
    assert np.abs(fan - par).max() / par.max() < 2e-2

    s = np.arange(N) - c
    peak = sig * np.sqrt(2 * np.pi)
    for i, th in enumerate(angles):
        u = np.array([np.cos(th), -np.sin(th)])  # detector-axis direction
        ana = peak * np.exp(-((s - p @ u) ** 2) / (2 * sig**2))
        assert np.abs(par[0, 0, i] - ana).max() / peak < 3e-2
        assert np.abs(fan[0, 0, i] - ana).max() / peak < 3e-2


def test_fan_cp_reconstruction():
    """TV-regularized CP reconstruction through the fan-beam projector."""
    from pytv4d_tpu.models.ct import FanBeamGeometry, radon_fan

    truth = (synthetic_phantom(32).astype(np.float32) / 255.0)[None, None]
    angles = jnp.linspace(0, 2 * np.pi, 48, endpoint=False)
    geom = FanBeamGeometry(source_dist=64.0, det_dist=16.0)
    sino = radon_fan(truth, angles, geom)
    res = cp_reconstruct(sino, angles, truth.shape, n_iter=80, reg=0.02,
                         cfg=TVConfig(scheme="hybrid"), geom=geom)
    loss = np.asarray(res.loss)
    assert loss[-1] < 0.05 * loss[0]
    corr = np.corrcoef(np.asarray(res.x).ravel(), truth.ravel())[0, 1]
    assert corr > 0.95, f"fan-beam reconstruction correlation {corr:.3f}"


def test_sart_ordered_subsets():
    """OS-SART: residual decreases monotonically-ish, reconstructs the
    phantom, and more subsets converge faster per epoch (the OS property)."""
    from pytv4d_tpu.models.ct import sart

    truth = (synthetic_phantom(32).astype(np.float32) / 255.0)[None, None]
    angles = jnp.linspace(0, np.pi, 40, endpoint=False)
    sino = radon(truth, angles)

    res = sart(sino, angles, truth.shape, n_iter=6, n_subsets=8)
    r = np.asarray(res.residual)
    assert r[-1] < r[0] * 0.2
    corr = np.corrcoef(np.asarray(res.x).ravel(), truth.ravel())[0, 1]
    assert corr > 0.95, f"SART correlation {corr:.3f}"

    # ordered-subsets acceleration: 8 subsets beat 1 subset (= SIRT) after
    # the same number of epochs
    res1 = sart(sino, angles, truth.shape, n_iter=6, n_subsets=1)
    assert r[-1] < float(res1.residual[-1])

    # SART warm start cuts the TV solver's loss vs cold start
    cold = cp_reconstruct(sino, angles, truth.shape, n_iter=20, reg=0.01)
    warm = cp_reconstruct(sino, angles, truth.shape, n_iter=20, reg=0.01,
                          x_init=res.x)
    assert float(warm.loss[-1]) < float(cold.loss[-1])

    with pytest.raises(ValueError, match="divisible"):
        sart(sino, angles, truth.shape, n_subsets=7)


def test_sart_per_frame_angles_and_fan():
    """SART with per-frame angle sets (dynamic CT) and with the fan-beam
    projector."""
    import functools

    from pytv4d_tpu.models.ct import FanBeamGeometry, radon_fan, sart

    truth = np.zeros((1, 2, 16, 16), np.float32)
    truth[0, :, 5:11, 5:11] = 1.0
    angles = jnp.stack([jnp.linspace(0, np.pi, 12, endpoint=False),
                        jnp.linspace(0, np.pi, 12, endpoint=False) + 0.05])
    sino = radon(truth, angles)
    res = sart(sino, angles, truth.shape, n_iter=4, n_subsets=4)
    assert np.asarray(res.residual)[-1] < np.asarray(res.residual)[0]

    geom = FanBeamGeometry(source_dist=40.0)
    fan_fn = functools.partial(radon_fan, geom=geom)
    sino_f = radon_fan(truth, angles[0], geom)
    res_f = sart(sino_f, angles[0], truth.shape, n_iter=4, n_subsets=4,
                 project_fn=fan_fn)
    assert np.asarray(res_f.residual)[-1] < np.asarray(res_f.residual)[0]


def test_radon_angle_batching_matches_single_sweep():
    """Chunked-angle radon/backprojection (the production-scale path) must
    equal the single-sweep vmap bit-for-bit-ish."""
    from pytv4d_tpu.models.ct import fbp, radon

    rng = np.random.default_rng(21)
    vol = jnp.asarray(rng.random((2, 2, 24, 24)), jnp.float32)
    angles = jnp.linspace(0.0, np.pi, 13, endpoint=False)

    full = radon(vol, angles, angle_batch=100)
    for B in (1, 4, 5):  # incl. a non-divisor (padding path)
        got = radon(vol, angles, angle_batch=B)
        np.testing.assert_allclose(np.asarray(got), np.asarray(full),
                                   rtol=1e-5, atol=1e-4)

    # per-frame angle sets through the batched path
    pf = jnp.stack([angles, angles + 0.1])
    full_pf = radon(vol, pf, angle_batch=100)
    got_pf = radon(vol, pf, angle_batch=4)
    np.testing.assert_allclose(np.asarray(got_pf), np.asarray(full_pf),
                               rtol=1e-5, atol=1e-4)

    # fbp auto-batches; tiny sizes take the single-sweep branch — force the
    # chunked one via a small budget
    import pytv4d_tpu.models.ct as ct

    sino = full
    a = np.asarray(fbp(sino, angles))
    old = ct._RADON_GATHER_BUDGET
    try:
        ct._RADON_GATHER_BUDGET = 4096
        b = np.asarray(fbp(sino, angles))
    finally:
        ct._RADON_GATHER_BUDGET = old
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_cone_projector_adjointness():
    """Cone-beam A/A_T pass the dot-product oracle (SURVEY.md section 4
    oracle 1), incl. non-default detector dims."""
    from pytv4d_tpu.models.ct import ConeBeamGeometry, make_cone_projector

    shape = (6, 2, 20, 20)
    angles = jnp.linspace(0, 2 * np.pi, 8, endpoint=False)
    geom = ConeBeamGeometry(source_dist=50.0, det_dist=25.0)
    A, A_T = make_cone_projector(shape, angles, geom, n_det_v=10,
                                 n_det_u=24, dtype=jnp.float64)
    rng = np.random.default_rng(30)
    x = jnp.asarray(rng.random(shape))
    y = jnp.asarray(rng.random((2, 8, 10, 24)))
    lhs = float(jnp.sum(y * A(x)))
    rhs = float(jnp.sum(A_T(y) * x))
    assert abs(lhs - rhs) / abs(lhs) < 1e-12


def test_cone_parallel_limit():
    """As source_dist -> inf the cone closes to parallel beam: detector row
    v reads the parallel sinogram of slice z = v (unit detector pitch)."""
    from pytv4d_tpu.models.ct import ConeBeamGeometry, radon_cone

    N, Nz, sig = 32, 6, 4.0
    c = (N - 1) / 2
    rr, cc = np.meshgrid(np.arange(N) - c, np.arange(N) - c, indexing="ij")
    vol = np.stack([
        (z + 1) * np.exp(-((rr - 4.0) ** 2 + (cc + 6.0) ** 2) / (2 * sig**2))
        for z in range(Nz)
    ])[:, None]                                     # (Nz, 1, N, N)
    vol = jnp.asarray(vol, jnp.float64)
    angles = jnp.asarray(np.linspace(0, np.pi, 5, endpoint=False))
    par = np.asarray(radon(vol, angles))            # (Nz, 1, A, N)
    geom = ConeBeamGeometry(source_dist=1e6, det_dist=0.0,
                            det_spacing_u=1.0, det_spacing_v=1.0)
    cone = np.asarray(radon_cone(vol, angles, geom))  # (1, A, Nz, N)
    for z in range(Nz):
        assert (np.abs(cone[0, :, z] - par[z, 0]).max() / par.max()) < 2e-2


def test_cone_angle_batching_matches_single_sweep():
    from pytv4d_tpu.models.ct import ConeBeamGeometry, radon_cone

    rng = np.random.default_rng(31)
    vol = jnp.asarray(rng.random((4, 2, 16, 16)), jnp.float32)
    angles = jnp.linspace(0.0, 2 * np.pi, 7, endpoint=False)
    geom = ConeBeamGeometry(source_dist=40.0, det_dist=10.0)
    full = radon_cone(vol, angles, geom, angle_batch=100)
    assert full.shape == (2, 7, 4, 16)
    for B in (1, 3):
        got = radon_cone(vol, angles, geom, angle_batch=B)
        np.testing.assert_allclose(np.asarray(got), np.asarray(full),
                                   rtol=1e-5, atol=1e-4)
    pf = jnp.stack([angles, angles + 0.1])
    full_pf = radon_cone(vol, pf, geom, angle_batch=100)
    got_pf = radon_cone(vol, pf, geom, angle_batch=3)
    np.testing.assert_allclose(np.asarray(got_pf), np.asarray(full_pf),
                               rtol=1e-5, atol=1e-4)


def test_fdk_parallel_limit_matches_fbp():
    """In the parallel limit FDK reduces exactly to per-slice FBP (all cone
    weights -> 1, shared filter and backprojection normalization) — a tight
    structural oracle on the weighting/backprojection path."""
    from pytv4d_tpu.models.ct import ConeBeamGeometry, fbp, fdk

    N, Nz = 32, 4
    base = _disk_phantom(N, np.float64)
    truth = np.stack([base for _ in range(Nz)])[:, None]
    angles = jnp.asarray(np.linspace(0, 2 * np.pi, 64, endpoint=False))
    geom = ConeBeamGeometry(source_dist=1e6, det_dist=0.0,
                            det_spacing_u=1.0, det_spacing_v=1.0)
    # identical data through both pipelines: the parallel sinogram
    # (Nz, M, A, U) rearranged into the cone layout (M, A, V=Nz, U)
    sino_p = radon(jnp.asarray(truth), angles)
    sino_c = jnp.transpose(sino_p, (1, 2, 0, 3))
    rec_fdk = np.asarray(fdk(sino_c, angles, geom, truth.shape))
    rec_fbp = np.asarray(fbp(sino_p, angles))
    z = Nz // 2
    np.testing.assert_allclose(rec_fdk[z, 0], rec_fbp[z, 0],
                               atol=1e-3 * rec_fbp.max())


def test_fdk_reconstructs_phantom():
    """FDK on a full-circle cone scan recovers a compactly-supported
    phantom at the correct absolute scale (exact in the source plane,
    approximate off-plane — the usual FDK property)."""
    from pytv4d_tpu.models.ct import ConeBeamGeometry, fdk, radon_cone

    N, Nz = 32, 8
    base = _disk_phantom(N, np.float64)
    truth = np.stack([base * (0.5 + 0.5 * np.cos(np.pi * (z - 3.5) / 8))
                      for z in range(Nz)])[:, None]   # (Nz, 1, N, N)
    angles = jnp.asarray(np.linspace(0, 2 * np.pi, 64, endpoint=False))
    geom = ConeBeamGeometry(source_dist=64.0, det_dist=16.0)
    sino = radon_cone(jnp.asarray(truth), angles, geom, n_det_v=2 * Nz)
    rec = np.asarray(fdk(sino, angles, geom, truth.shape))
    assert rec.shape == truth.shape
    for z in (3, 4):   # central slices closest to the source plane
        corr = np.corrcoef(rec[z, 0].ravel(), truth[z, 0].ravel())[0, 1]
        assert corr > 0.97, f"slice {z} corr {corr:.3f}"
        scale = (np.percentile(rec[z, 0], 95)
                 / np.percentile(truth[z, 0], 95))
        assert 0.9 < scale < 1.1, f"slice {z} scale {scale:.3f}"
    corr_all = np.corrcoef(rec.ravel(), truth.ravel())[0, 1]
    assert corr_all > 0.95, f"volume corr {corr_all:.3f}"


def test_cone_cp_reconstruction_and_sart():
    """TV-regularized CP reconstruction and OS-SART through the cone-beam
    projector (angle_axis=1 for the (M, A, V, U) sinogram layout)."""
    import functools

    from pytv4d_tpu.models.ct import ConeBeamGeometry, radon_cone, sart

    N, Nz = 16, 4
    base = synthetic_phantom(N).astype(np.float32) / 255.0
    truth = np.stack([base for _ in range(Nz)])[:, None]
    angles = jnp.asarray(np.linspace(0, 2 * np.pi, 24, endpoint=False),
                         jnp.float32)
    geom = ConeBeamGeometry(source_dist=32.0, det_dist=8.0)
    sino = radon_cone(jnp.asarray(truth), angles, geom)
    res = cp_reconstruct(sino, angles, truth.shape, n_iter=60, reg=0.02,
                         cfg=TVConfig(scheme="hybrid"), geom=geom)
    loss = np.asarray(res.loss)
    assert loss[-1] < 0.1 * loss[0]
    corr = np.corrcoef(np.asarray(res.x).ravel(), truth.ravel())[0, 1]
    assert corr > 0.9, f"cone CP reconstruction correlation {corr:.3f}"

    with pytest.raises(ValueError, match="cone-beam sinogram"):
        cp_reconstruct(sino[:, :, :2], angles, (Nz, 2, N, N), geom=geom)

    res_s = sart(sino, angles, truth.shape, n_iter=3, n_subsets=4,
                 project_fn=functools.partial(radon_cone, geom=geom),
                 angle_axis=1)
    r = np.asarray(res_s.residual)
    assert r[-1] < r[0]


def test_tgv_reconstruction_beats_tv_on_ramp():
    """TGV-CT (models.tgv_reconstruct / solvers.tgv_inverse): on a
    piecewise-LINEAR phantom the second-order regularizer recovers the
    slope while TV staircases — lower RMSE at matched iteration count —
    and the objective decreases."""
    from pytv4d_tpu.models.ct import cp_reconstruct, radon, tgv_reconstruct

    N = 24
    yy = np.linspace(-1, 1, N)[:, None] * np.ones((1, N))
    xx = np.ones((N, 1)) * np.linspace(-1, 1, N)[None, :]
    disk = (xx ** 2 + yy ** 2) <= 0.81
    ramp = np.where(disk, 0.5 + 0.5 * yy, 0.0)  # linear inside a disk
    truth = ramp[None, None].astype(np.float64)  # (1, 1, N, N)

    angles = jnp.linspace(0, np.pi, 16, endpoint=False)
    sino = radon(truth, angles)
    rng = np.random.default_rng(0)
    sino_noisy = np.asarray(sino) + 0.4 * rng.standard_normal(sino.shape)

    # TGV-CT converges slower than TV-CT — the advantage appears after
    # ~1000 iterations (measured: at 300 TV still leads)
    tv = cp_reconstruct(sino_noisy, angles, truth.shape, n_iter=1500,
                        reg=1.2, op_norm=float(N))
    tgv = tgv_reconstruct(sino_noisy, angles, truth.shape, n_iter=1500,
                          alpha1=1.2, alpha0=2.4, op_norm=float(N))

    mask = disk[None, None]
    err_tv = float(np.sqrt(np.mean((np.asarray(tv.x) - truth)[mask] ** 2)))
    err_tgv = float(np.sqrt(np.mean((np.asarray(tgv.x) - truth)[mask] ** 2)))
    assert err_tgv < err_tv, (err_tgv, err_tv)
    loss = np.asarray(tgv.loss)
    assert loss[-1] < loss[10]
    assert np.all(np.isfinite(loss))


def test_tgv_inverse_identity_matches_denoise():
    """tgv_inverse with A = identity solves the same objective as
    tgv_denoise — the iterates differ (different step rule/formulation) but
    both converge to the same unique minimizer of the strongly convex
    problem."""
    from pytv4d_tpu.solvers.tgv import tgv_denoise, tgv_inverse

    rng = np.random.default_rng(5)
    x0 = jnp.asarray(rng.random((2, 2, 16, 16)))
    den = tgv_denoise(x0, n_iter=600, alpha1=0.1, alpha0=0.2)
    inv = tgv_inverse(lambda v: v, x0, x0.shape, n_iter=600, alpha1=0.1,
                      alpha0=0.2)
    np.testing.assert_allclose(np.asarray(inv.x), np.asarray(den.x),
                               atol=2e-4, rtol=1e-3)
    with pytest.raises(ValueError, match="rank-4"):
        tgv_inverse(lambda v: v, x0, (16, 16))


def test_tgv_reconstruct_precond_converges_faster():
    """Diagonal preconditioning (Pock-Chambolle 2011, exact row/col sums —
    the CT projector's nonnegative coefficients make |A|1 = A1): 200
    preconditioned iterations reach a LOWER objective and RMSE than 1500
    plain iterations on the TGV-CT ramp experiment."""
    from pytv4d_tpu.models.ct import radon, tgv_reconstruct

    N = 24
    yy = np.linspace(-1, 1, N)[:, None] * np.ones((1, N))
    xx = np.ones((N, 1)) * np.linspace(-1, 1, N)[None, :]
    disk = (xx ** 2 + yy ** 2) <= 0.81
    truth = np.where(disk, 0.5 + 0.5 * yy, 0.0)[None, None]
    angles = jnp.linspace(0, np.pi, 16, endpoint=False)
    rng = np.random.default_rng(0)
    sn = np.array(radon(truth, angles)) + 0.4 * rng.standard_normal(
        (1, 1, 16, 24))

    plain = tgv_reconstruct(sn, angles, truth.shape, n_iter=1500,
                            alpha1=1.2, alpha0=2.4, op_norm=float(N))
    fast = tgv_reconstruct(sn, angles, truth.shape, n_iter=200,
                           alpha1=1.2, alpha0=2.4, precond=True)
    assert float(fast.loss[-1]) < float(plain.loss[-1])
    mask = disk[None, None]
    e_plain = float(np.sqrt(np.mean((np.asarray(plain.x) - truth)[mask] ** 2)))
    e_fast = float(np.sqrt(np.mean((np.asarray(fast.x) - truth)[mask] ** 2)))
    assert e_fast <= e_plain * 1.01, (e_fast, e_plain)


def test_cp_reconstruct_precond_converges_faster():
    """Diagonal preconditioning on TV-CT (cp_inverse precond=True): 100
    preconditioned iterations reach a lower objective than 600 plain."""
    from pytv4d_tpu.models.ct import cp_reconstruct, radon
    from pytv4d_tpu.utils import synthetic_phantom

    truth = (synthetic_phantom(32).astype(np.float64) / 255.0)[None, None]
    angles = jnp.linspace(0, np.pi, 24, endpoint=False)
    rng = np.random.default_rng(0)
    sn = np.array(radon(truth, angles)) + 0.2 * rng.standard_normal(
        (1, 1, 24, 32))

    plain = cp_reconstruct(sn, angles, truth.shape, n_iter=600, reg=0.3,
                           op_norm=32.0)
    fast = cp_reconstruct(sn, angles, truth.shape, n_iter=100, reg=0.3,
                          precond=True)
    assert float(fast.loss[-1]) < float(plain.loss[-1])
    assert np.all(np.isfinite(np.asarray(fast.x)))


def test_tgv_reconstruct_rejects_unimplemented_options():
    """dual_dtype/loss_every are in the signature for symmetry with
    cp_reconstruct but tgv_inverse does not implement them — explicit
    arguments must raise, never be silently ignored."""
    from pytv4d_tpu.models.ct import radon, tgv_reconstruct

    truth = jnp.zeros((1, 1, 16, 16))
    angles = jnp.linspace(0, np.pi, 8, endpoint=False)
    sino = radon(truth, angles)
    for kw in ({"dual_dtype": "bfloat16"}, {"loss_every": 5}):
        with pytest.raises(NotImplementedError, match="tgv_reconstruct"):
            tgv_reconstruct(sino, angles, truth.shape, n_iter=5, **kw)


def test_projector_cache_lru_and_clear():
    """make_projector memoization: hits refresh recency (LRU, not FIFO —
    a hot geometry must survive a sweep of one-off ones), and
    clear_projector_cache releases everything."""
    from pytv4d_tpu.models import ct as ct_mod
    from pytv4d_tpu.models.ct import clear_projector_cache, make_projector

    clear_projector_cache()
    assert len(ct_mod._PROJECTOR_CACHE) == 0
    hot_angles = np.linspace(0, np.pi, 4, endpoint=False)
    hot = make_projector((1, 1, 8, 8), hot_angles)
    # fill the cache with one-off geometries, touching the hot one between
    for n in range(3, 3 + ct_mod._PROJECTOR_CACHE_MAX - 1):
        make_projector((1, 1, 8, 8), np.linspace(0, np.pi, n))
        assert make_projector((1, 1, 8, 8), hot_angles) is hot  # refresh
    # one more insertion evicts the LRU entry — which must NOT be hot
    make_projector((1, 1, 8, 8), np.linspace(0, np.pi, 99))
    assert make_projector((1, 1, 8, 8), hot_angles) is hot
    clear_projector_cache()
    assert len(ct_mod._PROJECTOR_CACHE) == 0
    assert make_projector((1, 1, 8, 8), hot_angles) is not hot
    clear_projector_cache()
