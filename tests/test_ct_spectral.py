"""Gather-free spectral projector (models/ct_spectral.py).

Oracles: analytic Gaussian line integrals (the Radon transform of a
Gaussian is a Gaussian — an implementation-independent ground truth),
parity with the bilinear gather radon at the gather path's own O(h^2)
accuracy, the adjointness dot test, and a hard structural guarantee that
the lowered forward AND adjoint programs contain no gather/scatter HLO."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytv4d_tpu.models.ct import (
    FanBeamGeometry,
    cp_reconstruct,
    make_projector,
    radon,
)
from pytv4d_tpu.models.ct_spectral import (
    make_spectral_projector,
    radon_spectral,
)


def _gaussians(N, blobs):
    c0 = (N - 1) / 2.0
    rr, cc = np.meshgrid(np.arange(N) - c0, np.arange(N) - c0,
                         indexing="ij")
    img = np.zeros((N, N))
    for (r0, c0b, sig, amp) in blobs:
        img += amp * np.exp(-((rr - r0) ** 2 + (cc - c0b) ** 2)
                            / (2 * sig ** 2))
    return img


def _analytic_radon(N, n_det, angles, blobs):
    """Radon of sum-of-Gaussians: each blob projects to
    amp * sig * sqrt(2 pi) * exp(-(s - s0)^2 / (2 sig^2)),
    s0 = r0 cos(t) - c0 sin(t) (the projector's detector convention)."""
    s = np.arange(n_det) - (n_det - 1) / 2.0
    out = np.zeros((len(angles), n_det))
    for i, t in enumerate(angles):
        for (r0, c0b, sig, amp) in blobs:
            s0 = r0 * np.cos(t) - c0b * np.sin(t)
            out[i] += amp * sig * np.sqrt(2 * np.pi) * np.exp(
                -(s - s0) ** 2 / (2 * sig ** 2))
    return out


BLOBS = [(0.0, 0.0, 12.0, 1.0), (15.0, -10.0, 8.0, 0.7),
         (-20.0, 5.0, 10.0, 0.5)]


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_spectral_matches_analytic_gaussians():
    """Spectral accuracy: <= 1e-5 against analytic line integrals, and
    strictly tighter than the gather path's bilinear O(h^2) error on the
    same phantom (angles span both NUDFT regimes incl. the 45-degree
    boundary)."""
    N = 128
    img = _gaussians(N, BLOBS)
    vol = jnp.asarray(img[None, None])
    angles = np.concatenate([
        np.linspace(0, np.pi, 24, endpoint=False),
        [np.pi / 4, 3 * np.pi / 4],      # exact regime boundary
    ])
    ana = _analytic_radon(N, N, angles, BLOBS)
    ps = np.asarray(radon_spectral(vol, angles))[0, 0]
    pg = np.asarray(radon(vol, jnp.asarray(angles)))[0, 0]
    assert _rel(ps, ana) < 1e-5
    assert _rel(pg, ana) < 2e-3           # gather's own bilinear error
    assert _rel(ps, ana) < 0.1 * _rel(pg, ana)


def test_spectral_gather_parity_smooth_phantom():
    """Direct parity with the gather radon at ~1e-4 on a smooth in-disk
    phantom at N=256 — the residual IS the gather path's interpolation
    error (its analytic error is the same size; see the analytic test)."""
    N = 256
    blobs = [(0.0, 0.0, 32.0, 1.0), (20.0, -15.0, 28.0, 0.6)]
    vol = jnp.asarray(_gaussians(N, blobs)[None, None])
    angles = np.linspace(0, np.pi, 8, endpoint=False) + 0.03
    pg = np.asarray(radon(vol, jnp.asarray(angles)))[0, 0]
    ps = np.asarray(radon_spectral(vol, angles))[0, 0]
    assert _rel(pg, ps) < 1.5e-4


def test_spectral_adjointness_and_linearity():
    rng = np.random.default_rng(3)
    shape = (3, 2, 32, 32)
    angles = np.linspace(0, np.pi, 11, endpoint=False) + 0.05
    A, A_T = make_spectral_projector(shape, angles, dtype=jnp.float64)
    x = jnp.asarray(rng.random(shape))
    y = jnp.asarray(rng.random((3, 2, 11, 32)))
    lhs = float(jnp.vdot(y, A(x)))
    rhs = float(jnp.vdot(A_T(y), x))
    assert abs(lhs - rhs) / abs(lhs) < 1e-13
    # linearity (the map must be exactly linear for CP convergence theory)
    x2 = jnp.asarray(rng.random(shape))
    np.testing.assert_allclose(
        np.asarray(A(2.0 * x + 0.5 * x2)),
        np.asarray(2.0 * A(x) + 0.5 * A(x2)), rtol=1e-12, atol=1e-12)


def test_spectral_hlo_has_no_gather_or_scatter():
    """The whole point: forward and adjoint lower to FFT + matmul +
    elementwise only.  jnp.take-style reordering or map_coordinates
    would reintroduce a gather."""
    rng = np.random.default_rng(0)
    vol = jnp.asarray(rng.random((2, 2, 32, 32)), jnp.float32)
    # deliberately interleaved regimes so the un-permutation path runs
    angles = np.asarray([0.1, 1.3, 0.4, 1.9, 2.8, 1.0])
    A, A_T = make_spectral_projector(vol.shape, angles, dtype=jnp.float32)
    fwd = jax.jit(A).lower(vol).compile().as_text()
    sino = A(vol)
    adj = jax.jit(A_T).lower(sino).compile().as_text()
    for txt, what in ((fwd, "forward"), (adj, "adjoint")):
        # match op APPLICATIONS (`%x = ... gather(...)`) — a bare substring
        # check would trip on HLO metadata (source paths, op names)
        assert " gather(" not in txt, f"gather op in {what} HLO"
        assert " scatter(" not in txt, f"scatter op in {what} HLO"


def test_spectral_per_frame_angles_and_chunking():
    rng = np.random.default_rng(1)
    vol = jnp.asarray(rng.random((2, 3, 24, 24)))
    base = np.linspace(0, np.pi, 9, endpoint=False)
    ang2 = np.stack([base, base + 0.11, base + 0.22])
    pf = radon_spectral(vol, ang2)
    assert pf.shape == (2, 3, 9, 24)
    for m in range(3):
        ps = radon_spectral(vol[:, m:m + 1], ang2[m])
        np.testing.assert_allclose(np.asarray(pf[:, m]),
                                   np.asarray(ps[:, 0]), atol=1e-12)
    p1 = radon_spectral(vol, base)
    p2 = radon_spectral(vol, base, angle_chunk=2)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), atol=1e-12)
    # n_det != N
    assert radon_spectral(vol, base, n_det=40).shape == (2, 3, 9, 40)


def test_spectral_input_validation():
    vol = jnp.zeros((2, 2, 16, 16))
    with pytest.raises(ValueError, match="rank-4"):
        radon_spectral(jnp.zeros((16, 16)), np.asarray([0.1]))
    with pytest.raises(ValueError, match="square"):
        radon_spectral(jnp.zeros((2, 2, 8, 16)), np.asarray([0.1]))
    with pytest.raises(ValueError, match="per-frame"):
        radon_spectral(vol, np.zeros((3, 4)))  # M mismatch
    with pytest.raises(ValueError, match="concrete"):
        jax.jit(lambda a: radon_spectral(vol, a))(jnp.asarray([0.1]))


def test_make_projector_method_selection():
    """'auto' resolves to gather on CPU (golden parity lives there);
    explicit 'spectral' works everywhere; unknown methods and
    spectral-with-fan/cone raise."""
    shape = (1, 1, 16, 16)
    angles = np.linspace(0, np.pi, 4, endpoint=False) + 0.1
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random(shape))
    A_auto, _ = make_projector(shape, angles, dtype=jnp.float64)
    A_g, _ = make_projector(shape, angles, dtype=jnp.float64,
                            method="gather")
    np.testing.assert_array_equal(np.asarray(A_auto(x)), np.asarray(A_g(x)))
    A_s, AT_s = make_projector(shape, angles, dtype=jnp.float64,
                               method="spectral")
    y = A_s(x)
    assert y.shape == (1, 1, 4, 16)
    lhs = float(jnp.vdot(y, A_s(x)))
    rhs = float(jnp.vdot(AT_s(y), x))
    assert abs(lhs - rhs) / abs(lhs) < 1e-13
    with pytest.raises(ValueError, match="unknown projector method"):
        make_projector(shape, angles, method="fourier")
    # fan + spectral is supported (rebinning) — one smoke iteration runs
    sino = jnp.zeros((1, 1, 4, 16))
    res = cp_reconstruct(sino, angles, shape, n_iter=1, method="spectral",
                         geom=FanBeamGeometry(source_dist=100.0),
                         op_norm=16.0)
    assert np.all(np.isfinite(np.asarray(res.loss)))


def test_cp_reconstruct_spectral_end_to_end():
    """TV-regularized reconstruction through the spectral projector
    converges and matches the gather-projector reconstruction closely
    (same solver, same data, two discretizations of the same operator)."""
    N = 32
    truth = _gaussians(N, [(0.0, 0.0, 6.0, 1.0), (6.0, -4.0, 3.0, 0.6)])
    vol_shape = (1, 1, N, N)
    vol = jnp.asarray(truth[None, None])
    angles = np.linspace(0, np.pi, 24, endpoint=False)
    sino = radon_spectral(vol, angles)
    res_s = cp_reconstruct(sino, angles, vol_shape, n_iter=150, reg=1e-3,
                           method="spectral")
    res_g = cp_reconstruct(np.asarray(radon(vol, jnp.asarray(angles))),
                           angles, vol_shape, n_iter=150, reg=1e-3,
                           method="gather")
    err_s = _rel(np.asarray(res_s.x[0, 0]), truth)
    err_g = _rel(np.asarray(res_g.x[0, 0]), truth)
    assert err_s < 0.02
    assert abs(err_s - err_g) < 0.01
    assert np.all(np.isfinite(np.asarray(res_s.loss)))
    assert res_s.loss[-1] < res_s.loss[0]


def test_spectral_precond_reconstruction():
    """precond=True works on the spectral projector: A(ones) stays
    strictly positive for n_det ~ N (the Gibbs dips of the spectral splat
    land OUTSIDE the detector extent), so the nonnegative-row gate passes
    and the diagonally-preconditioned solve converges — measured rel err
    ~5e-4 on a noiseless Gaussian at 200 iterations."""
    N = 32
    truth = _gaussians(N, [(0.0, 0.0, 6.0, 1.0)])
    vol = jnp.asarray(truth[None, None])
    angles = np.linspace(0, np.pi, 24, endpoint=False)
    sino = radon_spectral(vol, angles)
    res = cp_reconstruct(sino, angles, (1, 1, N, N), n_iter=200, reg=1e-3,
                         method="spectral", precond=True)
    assert _rel(np.asarray(res.x[0, 0]), truth) < 2e-3
    assert res.loss[-1] < 1e-2 * res.loss[0]


def test_spectral_mass_conservation_in_disk():
    """Sum over the detector equals the image mass for objects inside the
    inscribed disk (DC exactness of the Fourier-slice evaluation)."""
    N = 64
    img = _gaussians(N, [(2.0, -3.0, 7.0, 1.0)])
    vol = jnp.asarray(img[None, None])
    p = np.asarray(radon_spectral(vol, np.asarray([0.3, 1.2, 2.2]),
                                  n_det=2 * N))
    mass = float(np.sum(img))
    np.testing.assert_allclose(p[0, 0].sum(axis=-1), mass, rtol=1e-6)


def test_spectral_sharded_reconstruction_tracks_unsharded():
    """GSPMD on the (z, t) mesh: the spectral projector batches over z/t
    (FFT along detector-local axes, NUDFT einsums over leading batch dims),
    so a z/t-sharded cp_reconstruct must track the unsharded solve — same
    contract as the gather projector's sharded test."""
    from jax.sharding import Mesh
    import jax

    from pytv4d_tpu.models.ct import cp_reconstruct, sinogram_sharding

    devs = np.array(jax.devices()[:8]).reshape(4, 2)
    mesh = Mesh(devs, ("z", "t"))
    rng = np.random.default_rng(2)
    vol_shape = (8, 2, 24, 24)
    truth = jnp.asarray(rng.random(vol_shape))
    angles = np.linspace(0, np.pi, 12, endpoint=False)
    sino = radon_spectral(truth, angles)

    ref = cp_reconstruct(sino, angles, vol_shape, n_iter=25, reg=0.02,
                         op_norm=24.0, method="spectral")
    sino_sh = jax.device_put(sino, sinogram_sharding(mesh))
    res = cp_reconstruct(sino_sh, angles, vol_shape, n_iter=25, reg=0.02,
                         op_norm=24.0, method="spectral")
    np.testing.assert_allclose(np.asarray(res.loss), np.asarray(ref.loss),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               atol=1e-6, rtol=1e-5)


def test_fbp_spectral_backprojector():
    """fbp(method='spectral') — backprojection through the exact adjoint
    of the gather-free projector: recovers the phantom at the same
    correlation and absolute scale as the classical result, stays close to
    the gather backprojector, and lowers with NO gather/scatter op."""
    from pytv4d_tpu.models.ct import fbp

    c0 = 23.5
    rr, cc = np.meshgrid(np.arange(48) - c0, np.arange(48) - c0,
                         indexing="ij")
    truth = (rr ** 2 + cc ** 2 <= 14.0 ** 2).astype(np.float64)[None, None]
    angles = np.linspace(0, np.pi, 90, endpoint=False)
    sino = radon_spectral(jnp.asarray(truth), angles)

    rec = fbp(sino, angles, method="spectral")
    corr = np.corrcoef(np.asarray(rec).ravel(), truth.ravel())[0, 1]
    assert corr > 0.97, corr
    scale = (np.percentile(np.asarray(rec), 95)
             / np.percentile(truth, 95))
    assert 0.9 < scale < 1.1, scale

    rec_g = fbp(sino, angles, method="gather")
    rel = (np.linalg.norm(np.asarray(rec - rec_g))
           / np.linalg.norm(np.asarray(rec_g)))
    assert rel < 0.1, rel  # two backprojector discretizations

    f = jax.jit(lambda s: fbp(s, angles, method="spectral"))
    txt = f.lower(sino).compile().as_text()
    assert " gather(" not in txt and " scatter(" not in txt


def test_spectral_dynamic_ct_per_frame_reconstruction():
    """The paper's dynamic-CT setting through the spectral projector:
    per-frame interleaved sparse angles + time-coupled TV reconstruct
    better than frame-wise TV — same mechanism as the gather path."""
    from pytv4d_tpu.core.config import TVConfig
    from pytv4d_tpu.utils.metrics import psnr

    N, M, n_per = 32, 4, 6
    base = _gaussians(N, [(0.0, 0.0, 6.0, 1.0)])
    moving = np.stack([np.roll(base, m, axis=1) for m in range(M)])[None]
    frame_angles = np.stack([
        np.linspace(0, np.pi, n_per, endpoint=False)
        + m * np.pi / (M * n_per) for m in range(M)
    ])
    sino = radon_spectral(jnp.asarray(moving), frame_angles)
    cfg = TVConfig(scheme="hybrid", reg_time=1.0)
    rec = cp_reconstruct(sino, frame_angles, moving.shape, n_iter=150,
                         reg=0.02, cfg=cfg, method="spectral",
                         op_norm=float(N))
    rec_fw = cp_reconstruct(sino, frame_angles, moving.shape, n_iter=150,
                            reg=0.02, cfg=TVConfig(scheme="hybrid"),
                            method="spectral", op_norm=float(N))
    dr = float(moving.max() - moving.min())
    p_coupled = float(psnr(moving, np.asarray(rec.x), data_range=dr))
    p_frame = float(psnr(moving, np.asarray(rec_fw.x), data_range=dr))
    assert p_coupled > p_frame + 0.5, (p_coupled, p_frame)


def test_sart_spectral_incompatibility_is_explained():
    """The GENERIC ``project_fn`` route scans angle subsets as tracers —
    structurally incompatible with the spectral projector's trace-time
    NUDFT tables, and the error must be the clear concrete-angles message.
    (The supported route is ``sart(method='spectral')``, which builds one
    prepared projector per concrete subset — tested below.)"""
    import functools

    from pytv4d_tpu.models.ct import sart

    N = 32
    truth = _gaussians(N, [(0.0, 0.0, 6.0, 1.0)])[None, None]
    angles = np.linspace(0, np.pi, 24, endpoint=False)
    sino = radon_spectral(jnp.asarray(truth), angles)
    with pytest.raises(ValueError, match="concrete"):
        sart(sino, angles, truth.shape, n_iter=2, n_subsets=4,
             project_fn=functools.partial(radon_spectral))


def test_fan_spectral_rebinning():
    """Fan-beam via fan-to-parallel rebinning on the spectral projector:
    ~1e-3 parity with the gather fan projector on a smooth phantom, exact
    adjointness, the parallel limit (source_dist -> inf) approaches the
    parallel spectral projector, and the volume-sized program stays
    gather-free (the only gather resamples the A x n_s sinogram)."""
    from pytv4d_tpu.models.ct import FanBeamGeometry, radon_fan
    from pytv4d_tpu.models.ct_spectral import (
        make_fan_spectral_projector,
        radon_fan_spectral,
    )

    N = 128
    vol = jnp.asarray(_gaussians(N, BLOBS)[None, None])
    geom = FanBeamGeometry(source_dist=256.0, det_dist=64.0)
    angles = np.linspace(0, 2 * np.pi, 24, endpoint=False) + 0.02
    pg = np.asarray(radon_fan(vol, jnp.asarray(angles), geom))
    ps = np.asarray(radon_fan_spectral(vol, angles, geom))
    assert _rel(ps, pg) < 3e-3

    # adjointness (the whole rebinned chain is linear)
    shape = (2, 1, 48, 48)
    rng = np.random.default_rng(4)
    A, A_T = make_fan_spectral_projector(
        shape, angles[:9], FanBeamGeometry(source_dist=96.0),
        dtype=jnp.float64)
    x = jnp.asarray(rng.random(shape))
    y = jnp.asarray(rng.random((2, 1, 9, 48)))
    lhs = float(jnp.vdot(y, A(x)))
    rhs = float(jnp.vdot(A_T(y), x))
    assert abs(lhs - rhs) / abs(lhs) < 1e-12

    # parallel limit: a huge source distance closes the fan
    far = FanBeamGeometry(source_dist=1e7, det_dist=0.0, det_spacing=1.0)
    pfan = np.asarray(radon_fan_spectral(vol, angles[:6], far))
    ppar = np.asarray(radon_spectral(vol, angles[:6]))
    assert _rel(pfan, ppar) < 1e-3

    # per-frame angles
    vol2 = jnp.asarray(np.stack([np.asarray(vol[0, 0]),
                                 np.asarray(vol[0, 0]).T])[None])
    ang2 = np.stack([angles[:6], angles[:6] + 0.1])
    pf = radon_fan_spectral(vol2, ang2, geom)
    for m in range(2):
        pm = radon_fan_spectral(vol2[:, m:m + 1], ang2[m], geom)
        np.testing.assert_allclose(np.asarray(pf[:, m]),
                                   np.asarray(pm[:, 0]), atol=1e-12)


def test_fan_spectral_reconstruction():
    """cp_reconstruct(geom=fan, method='spectral') end-to-end (the cone +
    spectral combination is covered by the SSRB tests below — it became
    supported in round 4)."""
    from pytv4d_tpu.models.ct import FanBeamGeometry

    N = 32
    truth = _gaussians(N, [(0.0, 0.0, 6.0, 1.0)])
    geom = FanBeamGeometry(source_dist=96.0, det_dist=24.0)
    angles = np.linspace(0, 2 * np.pi, 32, endpoint=False)
    from pytv4d_tpu.models.ct_spectral import radon_fan_spectral

    sino = radon_fan_spectral(jnp.asarray(truth[None, None]), angles, geom)
    res = cp_reconstruct(sino, angles, (1, 1, N, N), n_iter=150, reg=1e-3,
                         geom=geom, method="spectral")
    assert _rel(np.asarray(res.x[0, 0]), truth) < 0.05


def test_spectral_bf16_storage_volume():
    """bf16 STORAGE volumes (the north-star format) must get
    full-precision projections: the NUDFT phases reach ~1e3 radians,
    where bf16 arithmetic would be whole radians of error — the kernel
    computes in f32 and only the output returns in the storage dtype."""
    vol64 = jnp.asarray(_gaussians(64, [(0.0, 0.0, 10.0, 1.0)])[None, None])
    angles = np.linspace(0, np.pi, 8, endpoint=False) + 0.04
    ref = np.asarray(radon_spectral(vol64.astype(jnp.float32), angles))
    p16 = radon_spectral(vol64.astype(jnp.bfloat16), angles)
    assert p16.dtype == jnp.bfloat16
    rel = _rel(np.asarray(p16, np.float32), ref)
    assert rel < 1e-2, rel  # input-quantization level, not phase garbage


def test_precomputed_tables_match_lazy_build():
    """make_spectral_projector's eager NUDFT tables (device-resident
    constants, the solver-scan fast path) must reproduce the lazy
    per-chunk build bit-for-bit up to summation order — forward AND
    adjoint, shared and per-frame angles."""
    rng = np.random.default_rng(7)
    shape = (2, 2, 32, 32)
    x = jnp.asarray(rng.random(shape))
    y = jnp.asarray(rng.random((2, 2, 9, 32)))
    shared = np.linspace(0, np.pi, 9, endpoint=False) + 0.03
    per_frame = np.stack([shared, shared + 0.11])
    for angles in (shared, per_frame):
        A_e, AT_e = make_spectral_projector(shape, angles,
                                            dtype=jnp.float64,
                                            precompute_tables=True)
        A_l, AT_l = make_spectral_projector(shape, angles,
                                            dtype=jnp.float64,
                                            precompute_tables=False,
                                            angle_chunk=3)
        np.testing.assert_allclose(np.asarray(A_e(x)), np.asarray(A_l(x)),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(np.asarray(AT_e(y)),
                                   np.asarray(AT_l(y)),
                                   rtol=1e-12, atol=1e-12)


def test_operator_protocol_reconstruction_matches_lazy():
    """cp_reconstruct through the prepare()/apply() protocol (tables
    hoisted out of the scan as traced consts) must match the lazy
    per-application build — same solver trajectory."""
    from pytv4d_tpu.models.ct import cp_reconstruct

    rng = np.random.default_rng(11)
    shape = (2, 2, 32, 32)
    vol = jnp.asarray(rng.random(shape), jnp.float32)
    angles = np.linspace(0, np.pi, 12, endpoint=False) + 0.02
    A_e, _ = make_spectral_projector(shape, angles, precompute_tables=True)
    A_l, _ = make_spectral_projector(shape, angles, precompute_tables=False)
    assert hasattr(A_e, "prepare") and not hasattr(A_l, "prepare")
    sino = A_l(vol)

    def recon(A):
        from pytv4d_tpu.solvers.inverse import cp_inverse

        return cp_inverse(A, sino, shape, n_iter=6, reg=0.1, op_norm=30.0)

    res_e, res_l = recon(A_e), recon(A_l)
    np.testing.assert_allclose(np.asarray(res_e.x), np.asarray(res_l.x),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(res_e.loss),
                               np.asarray(res_l.loss), rtol=1e-5)


@pytest.mark.parametrize("regime", ["vertical", "horizontal", "both"])
def test_fft_spectrum_f32_matches_f64(regime):
    """The rfft half-spectrum path in f32 agrees with the same projector
    in f64 to f32 round-off, in each regime bucket (|sin| >= |cos| takes
    the column FFT, |cos| > |sin| the row FFT) and across both."""
    lo, hi = {"vertical": (np.pi / 4, 3 * np.pi / 4),
              "horizontal": (-np.pi / 4 + 0.01, np.pi / 4 - 0.01),
              "both": (0.0, np.pi)}[regime]
    angles = np.linspace(lo, hi, 24, endpoint=False)
    vol = np.random.default_rng(0).random((2, 2, 64, 64))
    p32 = np.asarray(radon_spectral(jnp.asarray(vol, jnp.float32), angles))
    p64 = np.asarray(radon_spectral(jnp.asarray(vol, jnp.float64), angles))
    assert p32.dtype == np.float32 and p64.dtype == np.float64
    assert np.linalg.norm(p32 - p64) / np.linalg.norm(p64) < 5e-6


def test_projector_precision_kwarg():
    """``precision`` plumbs through make_projector/cp_reconstruct: each
    precision gets its own cached pair, and the reconstruction still
    converges (values differ only at the matmul-precision level — on CPU
    all tiers are true f32, so the results agree to round-off)."""
    from pytv4d_tpu.models.ct import clear_projector_cache

    clear_projector_cache()
    vshape = (1, 1, 32, 32)
    angles = np.linspace(0.0, np.pi, 16, endpoint=False)
    A_hi, _ = make_projector(vshape, angles, method="spectral",
                             precision="highest")
    A_df, _ = make_projector(vshape, angles, method="spectral",
                             precision="default")
    assert A_hi is not A_df
    assert make_projector(vshape, angles, method="spectral",
                          precision="highest")[0] is A_hi

    rng = np.random.default_rng(3)
    vol = jnp.asarray(rng.random(vshape), jnp.float32)
    sino = A_hi(vol)
    res = cp_reconstruct(sino, angles, vshape, n_iter=20, reg=0.05,
                         method="spectral", precision="default")
    assert np.all(np.isfinite(np.asarray(res.x)))
    clear_projector_cache()


def test_sart_spectral_matches_plain_loop_reference():
    """``sart(method='spectral')`` (per-subset prepared projectors,
    unrolled sub-steps, tables threaded through the epoch scan) is
    mathematically the SART recursion: assert against a plain python-loop
    implementation on lazy spectral projectors to f32 round-off."""
    from pytv4d_tpu.models.ct import clear_projector_cache, sart

    clear_projector_cache()
    vshape = (2, 2, 32, 32)
    angles = np.linspace(0, np.pi, 16, endpoint=False)
    vol = jnp.asarray(np.broadcast_to(
        _gaussians(32, [(0.0, 0.0, 6.0, 1.0)]), vshape).copy(), jnp.float32)
    A_full, _ = make_spectral_projector(vshape, angles)
    sino = A_full(vol)

    res = sart(sino, angles, vshape, n_iter=5, n_subsets=4,
               method="spectral")
    assert np.all(np.diff(np.asarray(res.residual)) < 0)  # monotone drop

    S = 4
    idx = np.arange(16).reshape(-1, S).T
    x = jnp.zeros(vshape, jnp.float32)
    for _ in range(5):
        for k in idx:
            Ak, AkT = make_spectral_projector(vshape, angles[k])
            ones = jnp.ones(vshape, jnp.float32)
            row = jnp.maximum(Ak(ones), 1e-6)
            col = jnp.maximum(AkT(jnp.ones_like(row)), 1e-6)
            r = (sino[..., jnp.asarray(k), :] - Ak(x)) / row
            x = jnp.maximum(x + AkT(r) / col, 0.0)
    rel = float(jnp.linalg.norm(res.x - x) / jnp.linalg.norm(x))
    assert rel < 1e-5, rel
    clear_projector_cache()


def test_sart_spectral_tracks_gather_sart():
    """Spectral and gather SART solve the same problem with two
    discretizations of the same operator: on a smooth in-disk phantom
    their reconstructions agree to the operators' own ~1e-3 difference
    (bilinear interpolation error), far below the reconstruction scale."""
    from pytv4d_tpu.models.ct import sart

    N = 64
    truth = _gaussians(N, [(4.0, -6.0, 9.0, 1.0), (-8.0, 5.0, 7.0, 0.6)])
    vol = jnp.asarray(truth[None, None], jnp.float32)
    angles = np.linspace(0, np.pi, 32, endpoint=False)
    sino_s = radon_spectral(vol, angles)
    sino_g = radon(vol, jnp.asarray(angles))

    res_s = sart(sino_s, angles, vol.shape, n_iter=8, n_subsets=4,
                 method="spectral")
    res_g = sart(sino_g, angles, vol.shape, n_iter=8, n_subsets=4,
                 method="gather")
    rel = float(jnp.linalg.norm(res_s.x - res_g.x)
                / jnp.linalg.norm(res_g.x))
    assert rel < 2e-2, rel
    # and both recover the phantom
    for r in (res_s, res_g):
        err = float(jnp.linalg.norm(r.x[0, 0] - truth)
                    / np.linalg.norm(truth))
        assert err < 0.1, err


def test_sart_spectral_per_frame_angles():
    """Per-frame (M, n_angles) angle sets ride the spectral SART too —
    each frame gets its own per-subset tables."""
    from pytv4d_tpu.models.ct import sart

    vshape = (1, 2, 32, 32)
    base = np.linspace(0, np.pi, 16, endpoint=False)
    ang = np.stack([base, base + np.pi / 32])
    vol = jnp.asarray(np.broadcast_to(
        _gaussians(32, [(2.0, 1.0, 5.0, 1.0)]), vshape).copy(), jnp.float32)
    sino = radon_spectral(vol, ang)
    res = sart(sino, ang, vshape, n_iter=6, n_subsets=4, method="spectral")
    assert float(res.residual[-1]) < float(res.residual[0]) * 0.2
    err = float(jnp.linalg.norm(res.x - vol) / jnp.linalg.norm(vol))
    assert err < 0.15, err


# ---------------------------------------------------------------------------
# Gather-free cone beam: SSRB + first-order slope correction.
# Reference: the exact gather cone (models/ct.py
# radon_cone — trilinear sampling, itself golden-tested vs CPU f64).


def test_sart_cone_spectral_matches_plain_loop_reference():
    """``sart(geom=cone, method='spectral')``: the
    unrolled per-subset spectral-cone SART must equal a plain python-loop
    SART on the same lazy cone projectors to f32 round-off, and its
    residual must drop monotonically."""
    from pytv4d_tpu.models.ct import (
        ConeBeamGeometry,
        clear_projector_cache,
        sart,
    )
    from pytv4d_tpu.models.ct_spectral import (
        make_cone_spectral_projector,
        radon_cone_spectral,
    )

    clear_projector_cache()
    Nz, M, N, A = 4, 2, 32, 16
    vol = jnp.asarray(_thin_slab_phantom(Nz, M, N), jnp.float32)
    angles = np.linspace(0, 2 * np.pi, A, endpoint=False)
    geom = ConeBeamGeometry(source_dist=2.0 * N, det_dist=0.5 * N)
    sino = radon_cone_spectral(vol, angles, geom)

    res = sart(sino, angles, vol.shape, n_iter=5, n_subsets=4,
               method="spectral", geom=geom)
    assert np.all(np.diff(np.asarray(res.residual)) < 0)

    S = 4
    idx = np.arange(A).reshape(-1, S).T
    x = jnp.zeros(vol.shape, jnp.float32)
    for _ in range(5):
        for k in idx:
            Ak, AkT = make_cone_spectral_projector(
                vol.shape, angles[k], geom, n_det_v=sino.shape[2],
                n_det_u=sino.shape[3])
            # this compact geometry passes the health gate, so the cone
            # SART normalizes with the SIGNED sums (the wide-cone
            # surrogate leg is covered by
            # test_sart_cone_wide_geometry_is_stable)
            ones = jnp.ones(vol.shape, jnp.float32)
            row = jnp.maximum(Ak(ones), 1e-6)
            col = jnp.maximum(AkT(jnp.ones_like(row)), 1e-6)
            r = (jnp.take(sino, jnp.asarray(k), axis=1) - Ak(x)) / row
            x = jnp.maximum(x + AkT(r) / col, 0.0)
    rel = float(jnp.linalg.norm(res.x - x) / jnp.linalg.norm(x))
    assert rel < 1e-5, rel
    clear_projector_cache()


@pytest.mark.full
def test_sart_cone_wide_geometry_is_stable():
    """The health gate's surrogate leg: at a wide cone (D_so=1.5N,
    2Nz-row panel) the SIGNED row sums go negative on oblique rays and
    the naive normalization was measured to diverge (residual x1e4 per
    epoch); the abs-factor surrogate sums keep the sweep monotone and
    the reconstruction accurate."""
    from pytv4d_tpu.models.ct import ConeBeamGeometry, sart
    from pytv4d_tpu.models.ct_spectral import radon_cone_spectral

    Nz, N = 8, 64
    z, r, c = np.mgrid[:Nz, :N, :N]
    ph = np.exp(-(((z - 3.5) / 2.0) ** 2 + ((r - 30) / 8.0) ** 2
                  + ((c - 34) / 8.0) ** 2)).astype(np.float32)
    vol = ph[:, None]
    geom = ConeBeamGeometry(source_dist=1.5 * N, det_dist=24.0)
    ang = np.linspace(0, 2 * np.pi, 24, endpoint=False)
    sino = radon_cone_spectral(jnp.asarray(vol), ang, geom,
                               n_det_v=2 * Nz)
    res = sart(sino, ang, vol.shape, n_iter=8, n_subsets=4, geom=geom,
               method="spectral")
    resid = np.asarray(res.residual)
    assert np.all(np.isfinite(resid))
    assert np.all(np.diff(resid) < 0), resid
    assert _rel(np.asarray(res.x), vol) < 0.25


@pytest.mark.full
def test_sart_cone_geometries_reconstruct_and_warm_start():
    """Cone SART end-to-end: (a) ``geom=cone`` rides BOTH methods (the
    gather leg via the auto project_fn, the spectral leg via per-subset
    prepared cone projectors) and recovers a smooth phantom; (b) a
    SART-warm ``cp_reconstruct(geom=cone)`` beats the cold start at a
    fixed budget; (c) ``geom=fan`` smoke."""
    from pytv4d_tpu.core.config import TVConfig
    from pytv4d_tpu.models.ct import (
        ConeBeamGeometry,
        FanBeamGeometry,
        cp_reconstruct,
        estimate_op_norm,
        sart,
    )
    from pytv4d_tpu.models.ct_spectral import (
        make_cone_spectral_projector,
        radon_cone_spectral,
        radon_fan_spectral,
    )

    Nz, M, N, A = 6, 1, 32, 24
    vol = np.asarray(_fdk_smooth_phantom(Nz, M, N), np.float32)
    angles = np.linspace(0, 2 * np.pi, A, endpoint=False)
    geom = ConeBeamGeometry(source_dist=2.0 * N, det_dist=0.5 * N)
    sino = radon_cone_spectral(jnp.asarray(vol), angles, geom)

    res = sart(sino, angles, vol.shape, n_iter=10, n_subsets=4,
               method="spectral", geom=geom)
    assert float(res.residual[-1]) < 0.2 * float(res.residual[0])
    err_sart = _rel(np.asarray(res.x), vol)
    assert err_sart < 0.35, err_sart

    # gather leg on its own data (CPU path)
    from pytv4d_tpu.models.ct import radon_cone

    sino_g = radon_cone(jnp.asarray(vol), angles, geom)
    res_g = sart(sino_g, angles, vol.shape, n_iter=10, n_subsets=4,
                 method="gather", geom=geom)
    assert _rel(np.asarray(res_g.x), vol) < 0.35

    # SART-warm cone CP at a fixed budget
    Ax, ATx = make_cone_spectral_projector(vol.shape, angles, geom)
    on = float(estimate_op_norm(Ax, ATx, vol.shape))
    kw = dict(reg=0.05, cfg=TVConfig(scheme="hybrid"), geom=geom,
              op_norm=on, method="spectral")
    cold = cp_reconstruct(sino, angles, vol.shape, n_iter=30, **kw)
    warm = cp_reconstruct(sino, angles, vol.shape, n_iter=30,
                          x_init=res.x, **kw)
    assert _rel(np.asarray(warm.x), vol) < _rel(np.asarray(cold.x), vol)

    # fan geometry legs: spectral AND gather
    fgeom = FanBeamGeometry(source_dist=2.0 * N, det_dist=0.5 * N)
    fsino = radon_fan_spectral(jnp.asarray(vol), angles, fgeom)
    fres = sart(fsino, angles, vol.shape, n_iter=8, n_subsets=4,
                method="spectral", geom=fgeom)
    assert float(fres.residual[-1]) < 0.5 * float(fres.residual[0])
    from pytv4d_tpu.models.ct import radon_fan

    fsino_g = radon_fan(jnp.asarray(vol), jnp.asarray(angles), fgeom)
    fres_g = sart(fsino_g, angles, vol.shape, n_iter=8, n_subsets=4,
                  method="gather", geom=fgeom)
    assert float(fres_g.residual[-1]) < 0.5 * float(fres_g.residual[0])
    with pytest.raises(ValueError, match="unknown geometry"):
        sart(fsino, angles, vol.shape, geom=object())


def _thin_slab_phantom(Nz, M, N, seed=0, zs=6.0):
    rng = np.random.default_rng(seed)
    z, r, c = np.mgrid[:Nz, :N, :N]
    vol = np.zeros((Nz, M, N, N))
    for m in range(M):
        for _ in range(4):
            z0 = rng.uniform(2, Nz - 2)
            r0, c0 = rng.uniform(16, N - 16), rng.uniform(16, N - 16)
            vol[:, m] += np.exp(-((z - z0) ** 2 / zs + (r - r0) ** 2 / 50
                                  + (c - c0) ** 2 / 50))
    return vol


def test_cone_spectral_adjointness_linearity_layout():
    from pytv4d_tpu.models.ct import ConeBeamGeometry
    from pytv4d_tpu.models.ct_spectral import make_cone_spectral_projector

    rng = np.random.default_rng(5)
    shape = (4, 2, 32, 32)
    angles = np.linspace(0, 2 * np.pi, 7, endpoint=False) + 0.05
    geom = ConeBeamGeometry(source_dist=64.0, det_dist=16.0)
    A, A_T = make_cone_spectral_projector(shape, angles, geom,
                                          dtype=jnp.float64)
    x = jnp.asarray(rng.random(shape))
    y0 = A(x)
    assert y0.shape == (2, 7, 4, 32)      # (M, A, V, U) — cone layout
    y = jnp.asarray(rng.random(y0.shape))
    lhs = float(jnp.vdot(y, A(x)))
    rhs = float(jnp.vdot(A_T(y), x))
    assert abs(lhs - rhs) / abs(lhs) < 1e-12
    x2 = jnp.asarray(rng.random(shape))
    np.testing.assert_allclose(
        np.asarray(A(2.0 * x + 0.5 * x2)),
        np.asarray(2.0 * A(x) + 0.5 * A(x2)), rtol=1e-11, atol=1e-11)


def test_cone_spectral_parallel_limit():
    """source_dist -> inf closes the cone: detector row v reads slice v
    and the SSRB path must agree with the gather cone AND the per-slice
    parallel spectral projector (the correction term vanishes with
    sigma)."""
    from pytv4d_tpu.models.ct import ConeBeamGeometry, radon_cone
    from pytv4d_tpu.models.ct_spectral import radon_cone_spectral

    Nz, M, N = 6, 1, 64
    vol = jnp.asarray(_thin_slab_phantom(Nz, M, N))
    angles = np.linspace(0, 2 * np.pi, 8, endpoint=False) + 0.02
    far = ConeBeamGeometry(source_dist=1e7, det_dist=0.0,
                           det_spacing_u=1.0, det_spacing_v=1.0)
    ref = np.asarray(radon_cone(vol, jnp.asarray(angles), far))
    for order in (0, 1):
        ssrb = np.asarray(radon_cone_spectral(vol, angles, far,
                                              order=order))
        # residual = the rebinning-vs-bilinear difference (same order as
        # the fan test's 3e-3 bar); the cone term itself vanishes
        assert _rel(ssrb, ref) < 3e-3, (order, _rel(ssrb, ref))
    # and against the parallel spectral projector slice by slice
    par = np.asarray(radon_spectral(vol, angles))   # (Nz, M, A, U)
    ssrb1 = np.asarray(radon_cone_spectral(vol, angles, far))
    np.testing.assert_allclose(ssrb1, np.transpose(par, (1, 2, 0, 3)),
                               rtol=0, atol=1e-3 * np.abs(par).max())


def test_cone_spectral_gather_parity_and_order():
    """Recorded accuracy envelope vs the exact gather cone on a smooth
    thin-slab phantom (Nz=8, N=64): SSRB (order=0) error is O(sigma) —
    halving with each doubling of source_dist — and the first-order
    moment correction (order=1, default) roughly halves it again at
    every geometry.  Values recorded 2026-08:
    o0 5.4%/2.7%/1.4%, o1 2.9%/1.5%/0.9% at D_so = 2N/4N/8N."""
    from pytv4d_tpu.models.ct import ConeBeamGeometry, radon_cone
    from pytv4d_tpu.models.ct_spectral import radon_cone_spectral

    Nz, M, N = 8, 2, 64
    vol = jnp.asarray(_thin_slab_phantom(Nz, M, N))
    angles = np.linspace(0, 2 * np.pi, 24, endpoint=False)
    bars = {2.0: (0.08, 0.045), 4.0: (0.04, 0.025), 8.0: (0.025, 0.015)}
    errs = {}
    for mult, (bar0, bar1) in bars.items():
        geom = ConeBeamGeometry(source_dist=mult * N, det_dist=1.0 * N)
        ref = np.asarray(radon_cone(vol, jnp.asarray(angles), geom))
        e0 = _rel(np.asarray(radon_cone_spectral(vol, angles, geom,
                                                 order=0)), ref)
        e1 = _rel(np.asarray(radon_cone_spectral(vol, angles, geom,
                                                 order=1)), ref)
        assert e0 < bar0 and e1 < bar1, (mult, e0, e1)
        assert e1 < 0.7 * e0, (mult, e0, e1)  # the correction must help
        errs[mult] = (e0, e1)
    # O(sigma): error shrinks by ~2x per source-distance doubling
    assert errs[4.0][0] < 0.65 * errs[2.0][0]
    assert errs[8.0][0] < 0.65 * errs[4.0][0]


def test_cone_spectral_per_frame_angles():
    from pytv4d_tpu.models.ct import ConeBeamGeometry
    from pytv4d_tpu.models.ct_spectral import radon_cone_spectral

    Nz, M, N = 4, 2, 32
    vol = jnp.asarray(_thin_slab_phantom(Nz, M, N))
    geom = ConeBeamGeometry(source_dist=64.0, det_dist=16.0)
    base = np.linspace(0, 2 * np.pi, 6, endpoint=False)
    ang2 = np.stack([base, base + 0.1])
    pf = radon_cone_spectral(vol, ang2, geom)
    assert pf.shape == (M, 6, Nz, N)
    for m in range(M):
        pm = radon_cone_spectral(vol[:, m:m + 1], ang2[m], geom)
        np.testing.assert_allclose(np.asarray(pf[m]), np.asarray(pm[0]),
                                   atol=1e-12)


def test_cone_spectral_operator_protocol():
    """prepare()/apply(consts, x) returns the lazy result exactly (the
    consts are the dense parallel grid's NUDFT tables), and the solvers
    pick the protocol up through cp_reconstruct(geom=cone,
    method='spectral')."""
    from pytv4d_tpu.models.ct import ConeBeamGeometry, cp_reconstruct
    from pytv4d_tpu.models.ct_spectral import make_cone_spectral_projector

    rng = np.random.default_rng(7)
    Nz, M, N = 4, 1, 32
    shape = (Nz, M, N, N)
    angles = np.linspace(0, 2 * np.pi, 8, endpoint=False) + 0.03
    geom = ConeBeamGeometry(source_dist=64.0, det_dist=16.0)
    A, A_T = make_cone_spectral_projector(shape, angles, geom,
                                          dtype=jnp.float64)
    assert hasattr(A, "prepare") and hasattr(A, "apply")
    x = jnp.asarray(rng.random(shape))
    consts = A.prepare()
    np.testing.assert_allclose(np.asarray(A.apply(consts, x)),
                               np.asarray(A(x)), rtol=1e-12, atol=1e-12)


def test_cone_spectral_reconstruction_self_consistent():
    """Inverse-crime check: reconstructing a thin-slab phantom from the
    SSRB operator's own sinogram recovers it as well as the gather
    pipeline recovers from gather data (measured 2.8% vs 4.1% at this
    config) — the approximate operator is solver-consistent (exact
    adjoint).  Cross-model recon (gather data, spectral operator) is
    model-mismatch bound — same behavior and magnitude as the shipped
    fan rebinning path."""
    from pytv4d_tpu.models.ct import ConeBeamGeometry, cp_reconstruct
    from pytv4d_tpu.models.ct_spectral import radon_cone_spectral
    from pytv4d_tpu.core.config import TVConfig

    rng = np.random.default_rng(0)
    Nz, M, N, A = 8, 1, 64, 48
    z, r, c = np.mgrid[:Nz, :N, :N]
    truth = np.zeros((Nz, M, N, N), np.float32)
    for _ in range(4):
        z0 = rng.uniform(2, Nz - 2)
        r0, c0 = rng.uniform(16, N - 16), rng.uniform(16, N - 16)
        truth[:, 0] += (((z - z0) ** 2 / 4 + (r - r0) ** 2 / 64
                         + (c - c0) ** 2 / 64) < 1.0).astype(np.float32)
    truth = jnp.asarray(truth)
    angles = np.linspace(0, 2 * np.pi, A, endpoint=False)
    geom = ConeBeamGeometry(source_dist=2.0 * N, det_dist=1.0 * N)
    sino = radon_cone_spectral(truth, angles, geom)
    from pytv4d_tpu.models.ct import estimate_op_norm
    from pytv4d_tpu.models.ct_spectral import make_cone_spectral_projector
    Ax, ATx = make_cone_spectral_projector((Nz, M, N, N), angles, geom)
    on = float(estimate_op_norm(Ax, ATx, (Nz, M, N, N)))
    res = cp_reconstruct(sino, angles, (Nz, M, N, N), n_iter=400, reg=0.3,
                         cfg=TVConfig(scheme="hybrid"), geom=geom,
                         op_norm=on, method="spectral")
    err = _rel(np.asarray(res.x), np.asarray(truth))
    assert err < 0.06, err
    assert np.all(np.isfinite(np.asarray(res.loss)))
    assert res.loss[-1] < res.loss[0]


@pytest.mark.full
def test_cone_spectral_precond_converges_and_saves_iterations():
    """``precond=True`` on the spectral cone: the
    abs-factor surrogate sums + the power-method-verified step rescale
    must (a) converge — the SIGNED sums were measured to diverge — and
    (b) reach a LOWER loss than the op_norm-stepped solve at a 200-it
    horizon (measured crossover: op_norm leads early on this small
    geometry, where the cone's row sums are fairly homogeneous and the
    scalar rule is near-optimal; precond 760 vs op_norm 902 at 200 it,
    1507 vs 1295 at 60)."""
    from pytv4d_tpu.core.config import TVConfig
    from pytv4d_tpu.models.ct import (
        ConeBeamGeometry,
        cp_reconstruct,
        estimate_op_norm,
    )
    from pytv4d_tpu.models.ct_spectral import (
        make_cone_spectral_projector,
        radon_cone_spectral,
    )

    rng = np.random.default_rng(0)
    Nz, M, N, A = 8, 1, 64, 48
    z, r, c = np.mgrid[:Nz, :N, :N]
    truth = np.zeros((Nz, M, N, N), np.float32)
    for _ in range(4):
        z0 = rng.uniform(2, Nz - 2)
        r0, c0 = rng.uniform(16, N - 16), rng.uniform(16, N - 16)
        truth[:, 0] += (((z - z0) ** 2 / 4 + (r - r0) ** 2 / 64
                         + (c - c0) ** 2 / 64) < 1.0).astype(np.float32)
    truth = jnp.asarray(truth)
    angles = np.linspace(0, 2 * np.pi, A, endpoint=False)
    geom = ConeBeamGeometry(source_dist=2.0 * N, det_dist=1.0 * N)
    sino = radon_cone_spectral(truth, angles, geom)
    cfg = TVConfig(scheme="hybrid")
    kw = dict(reg=0.3, cfg=cfg, geom=geom, method="spectral")

    resp = cp_reconstruct(sino, angles, (Nz, M, N, N), n_iter=60,
                          precond=True, **kw)
    assert np.all(np.isfinite(np.asarray(resp.loss)))
    assert resp.loss[-1] < resp.loss[0]

    Ax, ATx = make_cone_spectral_projector((Nz, M, N, N), angles, geom)
    on = float(estimate_op_norm(Ax, ATx, (Nz, M, N, N)))
    reso = cp_reconstruct(sino, angles, (Nz, M, N, N), n_iter=60,
                          op_norm=on, **kw)
    # early horizon: within 2x of the scalar rule (NOT diverging — the
    # signed-sum preconditioner blew up to 8.9e32 at production scale)
    assert float(resp.loss[-1]) < 2.0 * float(reso.loss[-1]), (
        float(resp.loss[-1]), float(reso.loss[-1]))
    # 200-it horizon: preconditioned steps win
    resp2 = cp_reconstruct(sino, angles, (Nz, M, N, N), n_iter=200,
                           precond=True, **kw)
    reso2 = cp_reconstruct(sino, angles, (Nz, M, N, N), n_iter=200,
                           op_norm=on, **kw)
    assert float(resp2.loss[-1]) < float(reso2.loss[-1]), (
        float(resp2.loss[-1]), float(reso2.loss[-1]))


def _fdk_smooth_phantom(Nz, M, N):
    z, r, c = np.mgrid[:Nz, :N, :N]
    ph = np.zeros((Nz, N, N))
    for (z0, r0, c0, s) in [(Nz / 2 - 0.5, 0.47 * N, 0.53 * N, 0.11 * N),
                            (Nz / 2 + 1.0, 0.62 * N, 0.39 * N, 0.08 * N),
                            (Nz / 2 - 1.5, 0.39 * N, 0.62 * N, 0.09 * N)]:
        ph += np.exp(-(((z - z0) / 2.5) ** 2 + ((r - r0) / s) ** 2
                       + ((c - c0) / s) ** 2))
    return np.stack([ph * (1.0 - 0.2 * m) for m in range(M)], axis=1)


@pytest.mark.full
def test_fdk_spectral_parity_envelope():
    """``fdk(method='spectral')`` (rebinning P-FDK) vs
    the gather FDK on a smooth phantom, f64: the measured envelope is
    1.7%/0.7%/0.6% at D_so = 2N/4N/8N, and the wide-geometry limit equals
    the pure in-plane gather-vs-spectral BACKPROJECTOR family difference
    (~0.56% at N=64 on identical parallel data — the same floor the
    accepted ``fbp(method='spectral')`` carries), i.e. the cone-specific
    part of the new path is <=1e-3.  The spectral FDK is also CLOSER to
    the ground truth than the gather FDK at every geometry."""
    from pytv4d_tpu.models.ct import (
        ConeBeamGeometry,
        fbp,
        fdk,
        radon,
        radon_cone,
    )

    Nz, M, N, A = 8, 1, 64, 48
    vol = _fdk_smooth_phantom(Nz, M, N)
    volj = jnp.asarray(vol, jnp.float64)
    ang = np.linspace(0, 2 * np.pi, A, endpoint=False)

    # in-plane family floor: identical parallel data, two backprojectors
    angp = np.linspace(0, np.pi, A, endpoint=False)
    psino = radon(volj, angp)
    floor = _rel(np.asarray(fbp(psino, angp, method="spectral")),
                 np.asarray(fbp(psino, angp, method="gather")))
    assert floor < 0.01, floor

    bounds = {2.0: 0.025, 4.0: 0.012, 8.0: 0.009}
    for mult, bound in bounds.items():
        geom = ConeBeamGeometry(source_dist=mult * N, det_dist=0.5 * N)
        sino = radon_cone(volj, ang, geom)
        xg = np.asarray(fdk(sino, ang, geom, vol.shape, method="gather"))
        xs = np.asarray(fdk(sino, ang, geom, vol.shape, method="spectral"))
        assert _rel(xs, xg) < bound, (mult, _rel(xs, xg))
        # accuracy: the rebinning FDK beats the gather FDK vs truth
        assert _rel(xs, vol) <= _rel(xg, vol) * 1.02, (
            mult, _rel(xs, vol), _rel(xg, vol))

    # wide-geometry limit: parity collapses onto the in-plane floor —
    # the cone-specific contribution is at the 1e-3 level
    geom = ConeBeamGeometry(source_dist=64.0 * N, det_dist=0.5 * N)
    sino = radon_cone(volj, ang, geom)
    xg = np.asarray(fdk(sino, ang, geom, vol.shape, method="gather"))
    xs = np.asarray(fdk(sino, ang, geom, vol.shape, method="spectral"))
    assert _rel(xs, xg) < 1.2 * floor, (_rel(xs, xg), floor)


@pytest.mark.full
def test_fdk_spectral_warm_start_helps():
    """The production purpose of the spectral FDK: used as ``x_init`` for
    ``cp_reconstruct(geom=cone, method='spectral')`` it must cut the
    iterations needed to reach a fixed accuracy vs a cold start."""
    from pytv4d_tpu.core.config import TVConfig
    from pytv4d_tpu.models.ct import (
        ConeBeamGeometry,
        cp_reconstruct,
        estimate_op_norm,
        fdk,
    )
    from pytv4d_tpu.models.ct_spectral import (
        make_cone_spectral_projector,
        radon_cone_spectral,
    )

    Nz, M, N, A = 6, 1, 32, 24
    vol = _fdk_smooth_phantom(Nz, M, N).astype(np.float32)
    ang = np.linspace(0, 2 * np.pi, A, endpoint=False)
    geom = ConeBeamGeometry(source_dist=2.0 * N, det_dist=0.5 * N)
    sino = radon_cone_spectral(jnp.asarray(vol), ang, geom)
    x0 = fdk(sino, ang, geom, vol.shape, method="spectral")
    assert _rel(np.asarray(x0), vol) < 0.6  # sparse-view FDK is rough

    Ax, ATx = make_cone_spectral_projector(vol.shape, ang, geom)
    on = float(estimate_op_norm(Ax, ATx, vol.shape))
    kw = dict(reg=0.05, cfg=TVConfig(scheme="hybrid"), geom=geom,
              op_norm=on, method="spectral")
    cold = cp_reconstruct(sino, ang, vol.shape, n_iter=30, **kw)
    warm = cp_reconstruct(sino, ang, vol.shape, n_iter=30, x_init=x0, **kw)
    assert _rel(np.asarray(warm.x), vol) < _rel(np.asarray(cold.x), vol)


def test_modulated_radon_matches_bruteforce():
    """The offset-line evaluator (`_modulated_bucket`) must equal a
    direct pixel-sum NUDFT on the same trapezoidal lambda grid to machine
    precision, for both regimes and signed offsets — and reduce exactly
    to the real half-spectrum path at delta=0."""
    from pytv4d_tpu.models.ct_spectral import (
        _modulated_bucket,
        _modulated_dense,
        _radon_spectral_shared,
    )

    rng = np.random.default_rng(0)
    N, Np, n_det, ds = 16, 32, 20, 0.7
    img = rng.random((2, N, N)) + 1j * rng.random((2, N, N))
    imgj = jnp.asarray(img, jnp.complex128)
    c0 = (N - 1) / 2.0
    x = np.arange(N) - c0
    X, Y = np.meshgrid(x, x, indexing="ij")
    s_j = (np.arange(n_det) - (n_det - 1) / 2.0) * ds
    hi = jax.lax.Precision.HIGHEST
    ks = np.arange(Np + 1) - Np // 2
    nu = 2 * np.pi * ks / Np
    w = np.ones(Np + 1)
    w[0] = w[-1] = 0.5
    for vertical, angs in ((True, [1.2, np.pi / 2]), (False, [0.2, -0.5])):
        th = np.array(angs)
        for delta in (0.13, -0.27):
            out = np.asarray(_modulated_bucket(imgj, th, vertical, n_det,
                                               Np, ds, delta, hi))
            bf = np.zeros((2, len(th), n_det), complex)
            for a, t in enumerate(th):
                sin, cos = np.sin(t), np.cos(t)
                lam = (-(nu + delta * cos) / sin if vertical
                       else (nu + delta * sin) / cos)
                den = abs(sin) if vertical else abs(cos)
                s_p = X * cos - Y * sin
                t_p = X * sin + Y * cos
                for ki in range(Np + 1):
                    fh = np.sum(img * np.exp(1j * delta * t_p
                                             - 1j * lam[ki] * s_p),
                                axis=(-2, -1))
                    bf[:, a, :] += (w[ki] * fh[:, None]
                                    * np.exp(1j * lam[ki] * s_j)[None, :]
                                    / (Np * den))
            assert np.linalg.norm(out - bf) / np.linalg.norm(bf) < 1e-12
    # delta=0 degenerates to the real folded path, with zero imag part
    th = np.array([1.2, 1.9, 0.2, -0.5])
    ref = np.asarray(_radon_spectral_shared(
        jnp.asarray(np.real(img)[:, None], jnp.float64), th, n_det, None,
        det_spacing=ds, precision=hi))[:, 0]
    outd = np.asarray(_modulated_dense(
        jnp.asarray(np.real(img), jnp.complex128), th, n_det, ds, 0.0,
        hi))
    assert np.linalg.norm(outd - ref) / np.linalg.norm(ref) < 1e-12
    assert np.abs(np.imag(outd)).max() < 1e-12


def test_cone_zdft_adjoint_linearity_layout():
    """The z-DFT offset-line tier (order=2) is linear with an exact vjp
    adjoint and the cone layout, like every other order."""
    from pytv4d_tpu.models.ct import ConeBeamGeometry
    from pytv4d_tpu.models.ct_spectral import make_cone_spectral_projector

    rng = np.random.default_rng(5)
    shape = (4, 2, 24, 24)
    angles = np.linspace(0, 2 * np.pi, 5, endpoint=False) + 0.05
    geom = ConeBeamGeometry(source_dist=48.0, det_dist=12.0)
    A, A_T = make_cone_spectral_projector(shape, angles, geom,
                                          dtype=jnp.float64, order=2)
    x = jnp.asarray(rng.random(shape))
    y0 = A(x)
    assert y0.shape == (2, 5, 4, 24)
    y = jnp.asarray(rng.random(y0.shape))
    lhs = float(jnp.vdot(y, A(x)))
    rhs = float(jnp.vdot(A_T(y), x))
    assert abs(lhs - rhs) / abs(lhs) < 1e-11
    x2 = jnp.asarray(rng.random(shape))
    np.testing.assert_allclose(
        np.asarray(A(2.0 * x + 0.5 * x2)),
        np.asarray(2.0 * A(x) + 0.5 * A(x2)), rtol=1e-10, atol=1e-10)
    with pytest.raises(ValueError, match="z_kernel"):
        from pytv4d_tpu.models.ct_spectral import radon_cone_spectral

        radon_cone_spectral(x, angles, geom, order=2, z_kernel="nope")
    with pytest.raises(ValueError, match="order must be"):
        from pytv4d_tpu.models.ct_spectral import radon_cone_spectral

        radon_cone_spectral(x, angles, geom, order=3)


def _cone_gauss_oracle(blobs, ang, geom, Nz, N, M=1):
    """EXACT cone-beam line integrals of isotropic 3D Gaussians — an
    implementation-independent oracle (a Gaussian's integral along any
    3D line is closed-form), in the volume's own pixel frame."""
    cz, c0 = (Nz - 1) / 2.0, (N - 1) / 2.0
    pu, pv = geom.spacing_u(), geom.spacing_v()
    u_ax = (np.arange(N) - (N - 1) / 2.0) * pu
    v_ax = (np.arange(Nz) - (Nz - 1) / 2.0) * pv
    orc = np.zeros((M, len(ang), Nz, N))
    for a, b in enumerate(ang):
        sinb, cosb = np.sin(b), np.cos(b)
        Sr, Sc, Sz = (c0 - geom.source_dist * sinb,
                      c0 - geom.source_dist * cosb, cz)
        Dr = c0 + geom.det_dist * sinb + u_ax[None, :] * cosb
        Dc = c0 + geom.det_dist * cosb - u_ax[None, :] * sinb
        Dz = cz + v_ax[:, None] + 0 * Dr
        dr, dc, dz = Dr - Sr, Dc - Sc, Dz - Sz
        inv = 1.0 / np.sqrt(dr ** 2 + dc ** 2 + dz ** 2)
        dr, dc, dz = dr * inv, dc * inv, dz * inv
        for (z0, rr, cc, s, amp) in blobs:
            wr, wc, wz = Sr - rr * N, Sc - cc * N, Sz - z0
            proj = wr * dr + wc * dc + wz * dz
            rho2 = (wr ** 2 + wc ** 2 + wz ** 2) - proj ** 2
            orc[0, a] += amp * np.sqrt(np.pi) * s * np.exp(-rho2 / s ** 2)
    return orc


def _cone_blob_vol(blobs, Nz, N, M=1):
    z, r, c = np.mgrid[:Nz, :N, :N].astype(float)
    vol = np.zeros((Nz, M, N, N))
    for (z0, rr, cc, s, amp) in blobs:
        vol[:, 0] += amp * np.exp(-(((z - z0) ** 2 + (r - rr * N) ** 2
                                     + (c - cc * N) ** 2) / s ** 2))
    return vol


@pytest.mark.full
def test_cone_zdft_solver_consistency():
    """order=2 as the reconstruction operator: the exact-adjoint pair
    must drive cp_inverse to recover its own data (solver consistency),
    like every other tier."""
    from pytv4d_tpu.core.config import TVConfig
    from pytv4d_tpu.models.ct import estimate_op_norm
    from pytv4d_tpu.models.ct_spectral import make_cone_spectral_projector
    from pytv4d_tpu.solvers.inverse import cp_inverse

    Nz, M, N, A = 6, 1, 32, 16
    vol = np.asarray(_fdk_smooth_phantom(Nz, M, N), np.float32)
    ang = np.linspace(0, 2 * np.pi, A, endpoint=False)
    from pytv4d_tpu.models.ct import ConeBeamGeometry

    geom = ConeBeamGeometry(source_dist=2.0 * N, det_dist=0.5 * N)
    Ax, ATx = make_cone_spectral_projector(vol.shape, ang, geom, order=2)
    sino = Ax(jnp.asarray(vol))
    on = float(estimate_op_norm(Ax, ATx, vol.shape))
    res = cp_inverse(Ax, sino, vol.shape, A_T=ATx, n_iter=150, reg=0.02,
                     cfg=TVConfig(scheme="hybrid"), op_norm=on)
    assert _rel(np.asarray(res.x), vol) < 0.12
    assert float(res.loss[-1]) < float(res.loss[0])


@pytest.mark.full
def test_cone_zdft_beats_gather_vs_analytic():
    """The certification claim of the order=2 tier:
    against EXACT analytic cone integrals of 3D Gaussians, the z-DFT
    offset-line operator is MORE accurate than the gather cone at every
    geometry — the reference-style discretization's own trilinear error
    (~3.4% on sigma=2px features, step-refinement-invariant) is the true
    obstacle to 'parity', not our cone model.  Measured ladder (f64,
    (16,1,64,64) x 16, blobs sigma~2): gather 3.7/3.4%, order1 3.4/1.9%,
    zdft-trig 2.8/1.6% at oversample=2 -> 0.29/0.27% at oversample=8
    (the residual is rebinning interpolation, controlled by the knob).
    zdft's error is also geometry-INDEPENDENT — no slope expansion."""
    from pytv4d_tpu.models.ct import ConeBeamGeometry, radon_cone
    from pytv4d_tpu.models.ct_spectral import radon_cone_spectral

    Nz, N, A = 16, 64, 16
    blobs = [(5.5, 0.45, 0.55, 2.0, 1.0), (9.5, 0.60, 0.40, 2.2, 0.7),
             (7.5, 0.40, 0.42, 1.8, 0.5)]
    vol = jnp.asarray(_cone_blob_vol(blobs, Nz, N), jnp.float64)
    ang = np.linspace(0, 2 * np.pi, A, endpoint=False) + 0.03
    for mult in (2.0, 4.0):
        geom = ConeBeamGeometry(source_dist=mult * N, det_dist=0.5 * N)
        orc = _cone_gauss_oracle(blobs, ang, geom, Nz, N)
        rel = lambda a: np.linalg.norm(np.asarray(a) - orc) \
            / np.linalg.norm(orc)
        e_gather = rel(radon_cone(vol, ang, geom))
        e_zdft = rel(radon_cone_spectral(vol, ang, geom, order=2,
                                         z_kernel="trig"))
        e_zdft8 = rel(radon_cone_spectral(vol, ang, geom, order=2,
                                          z_kernel="trig", oversample=8.0))
        assert e_zdft < e_gather, (mult, e_zdft, e_gather)
        assert e_zdft8 < 0.004, (mult, e_zdft8)
        assert e_zdft8 < 0.15 * e_gather, (mult, e_zdft8, e_gather)
    # geometry independence: error flat from D_so=2N to 8N (order<=1
    # degrades toward small D_so; zdft has no slope expansion)
    geom2 = ConeBeamGeometry(source_dist=2.0 * N, det_dist=0.5 * N)
    geom8 = ConeBeamGeometry(source_dist=8.0 * N, det_dist=0.5 * N)
    e2 = np.linalg.norm(
        np.asarray(radon_cone_spectral(vol, ang, geom2, order=2,
                                       z_kernel="trig", oversample=4.0))
        - _cone_gauss_oracle(blobs, ang, geom2, Nz, N)) \
        / np.linalg.norm(_cone_gauss_oracle(blobs, ang, geom2, Nz, N))
    e8 = np.linalg.norm(
        np.asarray(radon_cone_spectral(vol, ang, geom8, order=2,
                                       z_kernel="trig", oversample=4.0))
        - _cone_gauss_oracle(blobs, ang, geom8, Nz, N)) \
        / np.linalg.norm(_cone_gauss_oracle(blobs, ang, geom8, Nz, N))
    # (the residual rebinning error is itself mildly geometry-dependent —
    # wider fan angles at small D_so steepen the resample coordinates)
    assert e2 < 5.0 * e8, (e2, e8)


def test_rebin_matmul_matches_map_coordinates():
    """The fan rebinning resample as two matmuls (_rebin_mats/_rebin_apply)
    must reproduce jax's bilinear map_coordinates to the ulp — including
    misaligned (non-integer ti) grids and both fold parities."""
    from pytv4d_tpu.models.ct_spectral import (
        _fan_dense_grid,
        _fold_pad,
        _rebin_apply,
        _rebin_mats,
    )

    rng = np.random.default_rng(0)
    for A, U, N, full, off in [(16, 64, 64, True, 0.0),
                               (17, 48, 64, False, 0.0371)]:
        ang = np.linspace(0, (2 if full else 1) * np.pi, A,
                          endpoint=False) + off
        geom = FanBeamGeometry(source_dist=2.0 * N, det_dist=1.0 * N)
        grid = _fan_dense_grid(ang, geom, U, N, 2.0)
        dense = jnp.asarray(rng.random((3, 2, len(grid.thetas), grid.n_s)))
        dp = _fold_pad(dense, grid.pad)
        ti = jnp.asarray(grid.ti)
        si = jnp.asarray(grid.si)
        ref = jax.vmap(jax.vmap(
            lambda p: jax.scipy.ndimage.map_coordinates(
                p, [ti, si], order=1, mode="constant", cval=0.0)))(dp)
        Ws, Wt = _rebin_mats(grid, dp.dtype)
        out = _rebin_apply(dp, Ws, Wt, "highest")
        assert float(jnp.max(jnp.abs(out - ref))) < 1e-13


def test_z_chunked_projector_identical():
    """z_chunk= streams the projector in z pieces: values must be
    IDENTICAL (z is a pure batch axis) and the prepare()/apply protocol
    must survive the wrapper."""
    vs = (8, 2, 32, 32)
    ang = np.linspace(0, np.pi, 12, endpoint=False)
    A, A_T = make_spectral_projector(vs, ang, dtype=jnp.float64)
    Ac, ATc = make_spectral_projector(vs, ang, dtype=jnp.float64,
                                      z_chunk=4)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random(vs))
    y = jnp.asarray(rng.random(A(x).shape))
    assert float(jnp.max(jnp.abs(Ac(x) - A(x)))) < 1e-12
    assert float(jnp.max(jnp.abs(ATc(y) - A_T(y)))) < 1e-12
    consts = Ac.prepare()
    assert float(jnp.max(jnp.abs(Ac.apply(consts, x) - A(x)))) < 1e-12
    lhs = float(jnp.vdot(Ac(x), y))
    rhs = float(jnp.vdot(x, ATc(y)))
    assert abs(lhs - rhs) < 1e-8 * abs(lhs)
    with pytest.raises(ValueError, match="z_chunk"):
        make_spectral_projector(vs, ang, z_chunk=3)
