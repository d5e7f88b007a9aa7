"""scikit-image-compat validation, two independent oracle kinds:

1. a literal transcription of the scikit-image algorithms against a
   DIFFERENT compute path (scipy.ndimage uniform_filter vs our jax conv
   — scikit-image itself is not in the image, and there is no network to
   record real outputs from);
2. implementation-independent ANALYTIC anchors that no shared
   transcription error can fake: closed-form SSIM for constant images,
   the exact discrete ROF solution for a two-plateau step (pins the
   weight convention and the upwind/forward-difference discretization =
   skimage's), and the certified duality gap of the denoiser's output.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi

from pytv4d_tpu.utils import metrics


def _skimage_ssim(x, y, data_range, win_size=7, k1=0.01, k2=0.03):
    """Verbatim port of skimage.metrics.structural_similarity's default
    (uniform-filter, sample-covariance) path for one 2D slice."""
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    filt = lambda a: ndi.uniform_filter(a, size=win_size)
    np_ = win_size ** 2
    cov_norm = np_ / (np_ - 1)
    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    pad = (win_size - 1) // 2
    return s[pad:-pad, pad:-pad].mean()


@pytest.fixture
def pair():
    rng = np.random.default_rng(7)
    truth = rng.random((48, 64)) * 200.0
    noisy = truth + rng.normal(0, 12.0, truth.shape)
    return truth, noisy


def test_mse_psnr(pair):
    truth, noisy = pair
    want_mse = np.mean((truth - noisy) ** 2)
    assert metrics.mse(truth, noisy) == pytest.approx(want_mse, rel=1e-6)
    dr = truth.max() - truth.min()
    want = 10 * np.log10(dr ** 2 / want_mse)
    assert metrics.psnr(truth, noisy) == pytest.approx(want, rel=1e-6)
    # explicit data_range
    assert metrics.psnr(truth, noisy, data_range=255.0) == pytest.approx(
        10 * np.log10(255.0 ** 2 / want_mse), rel=1e-6)


def test_psnr_integer_dtype_range():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 255, (32, 32), dtype=np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-5, 5, a.shape), 0,
                255).astype(np.uint8)
    want_mse = np.mean((a.astype(float) - b.astype(float)) ** 2)
    assert metrics.psnr(a, b) == pytest.approx(
        10 * np.log10(255.0 ** 2 / want_mse), rel=1e-6)


def test_nrmse_normalizations(pair):
    truth, noisy = pair
    rmse = np.sqrt(np.mean((truth - noisy) ** 2))
    assert metrics.nrmse(truth, noisy) == pytest.approx(
        rmse / np.sqrt(np.mean(truth ** 2)), rel=1e-6)
    assert metrics.nrmse(truth, noisy, "min-max") == pytest.approx(
        rmse / (truth.max() - truth.min()), rel=1e-6)
    assert metrics.nrmse(truth, noisy, "mean") == pytest.approx(
        rmse / truth.mean(), rel=1e-6)
    with pytest.raises(ValueError):
        metrics.nrmse(truth, noisy, "bogus")


def test_ssim_matches_skimage_algorithm(pair):
    truth, noisy = pair
    dr = truth.max() - truth.min()
    want = _skimage_ssim(truth, noisy, dr)
    got = metrics.ssim(truth, noisy)
    assert got == pytest.approx(want, rel=1e-5)
    # non-default window
    want5 = _skimage_ssim(truth, noisy, dr, win_size=5)
    assert metrics.ssim(truth, noisy, win_size=5) == pytest.approx(
        want5, rel=1e-5)


def test_ssim_identity_and_bounds(pair):
    truth, noisy = pair
    assert metrics.ssim(truth, truth.copy()) == pytest.approx(1.0, abs=1e-6)
    s = metrics.ssim(truth, noisy)
    assert -1.0 <= s < 1.0
    # more noise -> lower ssim
    worse = truth + np.random.default_rng(1).normal(0, 60.0, truth.shape)
    assert metrics.ssim(truth, worse, data_range=truth.max() - truth.min()) < s


def test_ssim_volume_is_mean_of_slices(pair):
    truth, noisy = pair
    vol_t = np.stack([truth, truth * 0.5 + 10], axis=0).reshape(2, 1, 48, 64)
    vol_n = np.stack([noisy, noisy * 0.5 + 10], axis=0).reshape(2, 1, 48, 64)
    dr = float(vol_t.max() - vol_t.min())
    per_slice = [
        metrics.ssim(vol_t[i, 0], vol_n[i, 0], data_range=dr)
        for i in range(2)
    ]
    got = metrics.ssim(vol_t, vol_n, data_range=dr)
    assert got == pytest.approx(np.mean(per_slice), rel=1e-6)
    m = metrics.ssim(vol_t, vol_n, data_range=dr, return_map=True)
    assert m.shape == (2, 1, 48 - 6, 64 - 6)


def test_validation_errors(pair):
    truth, noisy = pair
    with pytest.raises(ValueError):
        metrics.mse(truth, noisy[:-1])
    with pytest.raises(ValueError):
        metrics.ssim(truth, noisy, win_size=4)
    with pytest.raises(ValueError):
        metrics.ssim(np.ones((3, 3)), np.ones((3, 3)))  # smaller than window
    with pytest.raises(ValueError):
        metrics.psnr(np.ones((8, 8)), np.ones((8, 8)) * 2)  # constant float


def test_ssim_closed_form_constants():
    """Analytic anchors independent of ANY reference implementation: for
    constant images x=a, y=b all (co)variances vanish, so SSIM reduces to
    the luminance term (2ab + c1)/(a^2 + b^2 + c1) exactly (Wang et al.
    2004 eq. 13 with the skimage defaults k1=0.01, dr arbitrary)."""
    for a, b, dr in [(50.0, 80.0, 255.0), (0.2, 0.9, 1.0)]:
        x = np.full((32, 32), a)
        y = np.full((32, 32), b)
        c1 = (0.01 * dr) ** 2
        expect = (2 * a * b + c1) / (a * a + b * b + c1)
        got = metrics.ssim(x, y, data_range=dr)
        np.testing.assert_allclose(got, expect, rtol=1e-6)
    # identity: SSIM(x, x) == 1 exactly, for any image
    rng = np.random.default_rng(3)
    x = rng.random((40, 40)) * 100
    np.testing.assert_allclose(metrics.ssim(x, x, data_range=100.0), 1.0,
                               rtol=1e-6)


def test_denoise_tv_chambolle_exact_rof_solution():
    """Implementation-independent golden oracle: for a
    two-plateau step image the DISCRETE ROF problem
    min 1/2||u-f||^2 + w*TV_upwind(u) has the closed-form solution
    u = a + w/h on the top plateau and b - w/h on the bottom (each column
    is an independent 1-D problem; the plateaus shrink toward each other
    by w/h until they merge at w = h(b-a)/2, after which u = mean(f)).
    Upwind forward differences are exactly scikit-image's discretization,
    so this pins the weight convention (w multiplies TV against a
    1/2 quadratic) without needing scikit-image installed."""
    from pytv4d_tpu.models import denoise_tv_chambolle

    H, W = 32, 16
    a, b, w = 1.0, 3.0, 4.0
    h = H // 2
    img = np.full((H, W), a)
    img[h:] = b
    u = denoise_tv_chambolle(img, weight=w, scheme="upwind",
                             max_num_iter=3000)
    np.testing.assert_allclose(u[:h], a + w / h, atol=1e-6)
    np.testing.assert_allclose(u[h:], b - w / h, atol=1e-6)

    # past the merge threshold the solution is the global mean
    u2 = denoise_tv_chambolle(img, weight=1.1 * h * (b - a) / 2,
                              scheme="upwind", max_num_iter=4000)
    np.testing.assert_allclose(u2, (a + b) / 2, atol=1e-4)


def test_denoise_tv_chambolle_certified_optimality():
    """The denoiser's output must certifiably solve the objective it
    claims: re-solving with the underlying CP solver and evaluating the
    duality gap (solvers.pd_gap) bounds its distance to the true optimum
    — an oracle no port-vs-port comparison can fake."""
    import jax.numpy as jnp

    from pytv4d_tpu.core.config import TVConfig
    from pytv4d_tpu.models import denoise_tv_chambolle
    from pytv4d_tpu.solvers import chambolle_pock, pd_gap

    rng = np.random.default_rng(11)
    img = rng.random((24, 24)) * 10
    w = 1.5
    u = denoise_tv_chambolle(img, weight=w, max_num_iter=600)
    cfg = TVConfig()  # hybrid, the denoiser's default
    vol = jnp.asarray(img[None, None])
    res = chambolle_pock(vol, n_iter=600, reg=w, cfg=cfg)
    # same solve -> identical output (the wrapper adds no drift) ...
    np.testing.assert_allclose(u, np.asarray(res.x[0, 0]), atol=1e-10)
    # ... and the certified gap says both are within 0.1% of optimal
    gap = float(pd_gap(res.state, vol, reg=w, cfg=cfg))
    from pytv4d_tpu.ops.operators import D, tv_norm

    primal = float(0.5 * jnp.sum(jnp.square(res.x - vol))
                   + w * tv_norm(D(res.x, cfg.scheme), cfg.norm))
    assert gap >= 0.0
    assert gap <= 1e-3 * primal
