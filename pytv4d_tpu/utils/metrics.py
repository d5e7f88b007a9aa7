"""Image-quality metrics (MSE, NRMSE, PSNR, SSIM) — device-resident.

scikit-image-compatible semantics (``skimage.metrics``: mean_squared_error,
normalized_root_mse, peak_signal_noise_ratio, structural_similarity with its
default uniform 7x7 window, sample covariance and edge crop) so published
reconstruction-quality numbers are comparable, without a scikit-image
dependency.  Everything is jnp under the hood: the inputs may live on the
accelerator and the reductions run there; only the final scalar is pulled
to host.

The reference has no metrics module — examples eyeball plots
(``/root/reference/examples/a_TV_denoising_2D.ipynb``).  Quality metrics
make the solver examples and CT benchmarks self-reporting.

One deliberate deviation: for float images ``data_range=None`` infers
``truth.max() - truth.min()`` (documented, deterministic) instead of
scikit-image's legacy "assume the full dtype range" which silently yields
wrong PSNR for [0, 255]-scaled float images like ``utils.cameraman()``.
Pass ``data_range`` explicitly for strict parity.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["mse", "nrmse", "psnr", "ssim"]


def _as_f32_pair(a, b):
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    dt = jnp.promote_types(jnp.result_type(a), jnp.float32)
    return a.astype(dt), b.astype(dt)


def _infer_data_range(truth, data_range):
    if data_range is not None:
        return float(data_range)
    t = np.asarray(truth)
    if np.issubdtype(t.dtype, np.integer):
        info = np.iinfo(t.dtype)
        return float(info.max) - float(info.min)
    rng = float(t.max() - t.min())
    if rng == 0.0:
        raise ValueError(
            "data_range cannot be inferred from a constant float image; "
            "pass data_range explicitly")
    return rng


def mse(image_true, image_test) -> float:
    """Mean squared error (skimage ``mean_squared_error``)."""
    a, b = _as_f32_pair(image_true, image_test)
    return float(jnp.mean((a - b) ** 2))


def nrmse(image_true, image_test, normalization: str = "euclidean") -> float:
    """Normalized root MSE (skimage ``normalized_root_mse`` conventions:
    'euclidean' divides by sqrt(mean(truth^2)), 'min-max' by the truth
    range, 'mean' by the truth mean)."""
    a, b = _as_f32_pair(image_true, image_test)
    rmse = jnp.sqrt(jnp.mean((a - b) ** 2))
    if normalization == "euclidean":
        denom = jnp.sqrt(jnp.mean(a ** 2))
    elif normalization == "min-max":
        denom = a.max() - a.min()
    elif normalization == "mean":
        denom = jnp.mean(a)
    else:
        raise ValueError(f"unknown normalization {normalization!r}")
    return float(rmse / denom)


def psnr(image_true, image_test, data_range=None) -> float:
    """Peak signal-to-noise ratio in dB (skimage
    ``peak_signal_noise_ratio``; see module docstring for the float
    ``data_range`` inference). Returns ``inf`` for identical images."""
    dr = _infer_data_range(image_true, data_range)
    a, b = _as_f32_pair(image_true, image_test)
    err = jnp.mean((a - b) ** 2)
    return float(10.0 * jnp.log10((dr * dr) / err))


@functools.partial(jax.jit, static_argnames=("win_size", "k1", "k2"))
def _ssim_map_2d(x, y, data_range, win_size, k1, k2):
    """Per-slice SSIM maps. x, y: (B, Nr, Nc) float; returns
    (B, Nr-win+1, Nc-win+1) — the 'valid' region, which equals
    scikit-image's uniform_filter output after its (win_size-1)//2 crop."""
    w = jnp.full((1, 1, win_size, win_size), 1.0 / (win_size * win_size),
                 dtype=x.dtype)

    def box(a):
        # valid-mode box mean over the trailing two axes
        out = jax.lax.conv_general_dilated(
            a[:, None], w, window_strides=(1, 1), padding="VALID")
        return out[:, 0]

    ux, uy = box(x), box(y)
    uxx, uyy, uxy = box(x * x), box(y * y), box(x * y)
    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1.0)  # sample covariance, as scikit-image
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    return ((2.0 * ux * uy + c1) * (2.0 * vxy + c2)) / (
        (ux * ux + uy * uy + c1) * (vx + vy + c2))


def ssim(image_true, image_test, data_range=None, win_size: int = 7,
         k1: float = 0.01, k2: float = 0.03, return_map: bool = False):
    """Structural similarity (skimage ``structural_similarity`` defaults:
    uniform ``win_size`` x ``win_size`` window, sample covariance,
    ``(win_size-1)//2`` edge crop before the mean).

    Accepts a 2D image or any array whose trailing two axes are (row, col)
    — e.g. the canonical ``(Nz, M, N_row, N_col)`` volume: SSIM is computed
    per 2D slice and averaged.  ``return_map=True`` returns the per-pixel
    SSIM map(s) over the valid region instead of the scalar mean.
    """
    if win_size % 2 != 1 or win_size < 3:
        raise ValueError("win_size must be an odd integer >= 3")
    dr = _infer_data_range(image_true, data_range)
    a, b = _as_f32_pair(image_true, image_test)
    if a.ndim < 2 or a.shape[-1] < win_size or a.shape[-2] < win_size:
        raise ValueError(
            f"trailing image axes {a.shape[-2:]} smaller than "
            f"win_size={win_size}")
    lead = a.shape[:-2]
    s = _ssim_map_2d(a.reshape((-1,) + a.shape[-2:]),
                     b.reshape((-1,) + b.shape[-2:]),
                     jnp.asarray(dr, a.dtype), win_size, k1, k2)
    if return_map:
        return s.reshape(lead + s.shape[-2:])
    return float(jnp.mean(s))
