"""Bundled/test images — reference parity for ``pytv.utils.cameraman``
(``pytv/utils.py:46-55``: 256x256 int64 grayscale, value range 7-253).

The cameraman asset is vendored at ``pytv4d_tpu/media/cameraman.npy`` (the
reference ships the same bytes via ``MANIFEST.in:2``), so a standalone
checkout or wheel is self-contained.  :func:`cameraman` prefers
``$PYTV4D_CAMERAMAN`` when set, then the vendored asset; the deterministic
synthetic phantom remains as a last-resort fallback for stripped installs
(flagged via :func:`has_real_cameraman`).
"""

from __future__ import annotations

import os

import numpy as np

_SEARCH_PATHS = (
    os.environ.get("PYTV4D_CAMERAMAN", ""),
    os.path.join(os.path.dirname(os.path.dirname(__file__)), "media",
                 "cameraman.npy"),
    "/root/reference/pytv/media/cameraman.npy",
)


def _find_asset():
    for path in _SEARCH_PATHS:
        if path and os.path.isfile(path):
            return path
    return None


def has_real_cameraman() -> bool:
    """True when the actual cameraman asset is available on this machine."""
    return _find_asset() is not None


def cameraman() -> np.ndarray:
    """The 256x256 grayscale cameraman standard image (``pytv/utils.py:46-55``),
    or a deterministic synthetic stand-in when the asset is unavailable."""
    path = _find_asset()
    if path is not None:
        return np.load(path)
    return synthetic_phantom(256)


def synthetic_phantom(n: int = 256, seed: int = 0) -> np.ndarray:
    """Deterministic piecewise-smooth int64 test image in [7, 253].

    A Shepp-Logan-flavoured composition of ellipses plus a smooth ramp: has
    flat regions (exercising the nonsmooth-TV inf convention) and sharp edges
    (exercising the stencil boundaries), like the real cameraman.
    """
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64) / n - 0.5
    img = 120.0 + 80.0 * xx + 40.0 * yy
    ellipses = [
        # (cy, cx, ry, rx, angle, value)
        (0.0, 0.0, 0.42, 0.36, 0.0, 60.0),
        (-0.1, 0.05, 0.25, 0.18, 0.4, -45.0),
        (0.15, -0.12, 0.12, 0.2, -0.3, 70.0),
        (0.22, 0.18, 0.08, 0.06, 0.0, -80.0),
        (-0.25, -0.2, 0.05, 0.09, 0.8, 50.0),
    ]
    for cy, cx, ry, rx, ang, val in ellipses:
        c, s = np.cos(ang), np.sin(ang)
        u = (xx - cx) * c + (yy - cy) * s
        v = -(xx - cx) * s + (yy - cy) * c
        img = np.where((u / rx) ** 2 + (v / ry) ** 2 <= 1.0, img + val, img)
    rng = np.random.default_rng(seed)
    img = img + rng.normal(0.0, 2.0, size=(n, n))
    return np.clip(img, 7, 253).astype(np.int64)


def blob_phantom(vol_shape, n_blobs: int = 6, seed: int = 0) -> np.ndarray:
    """A float32 ``(Nz, M, N, N)`` volume of ``n_blobs`` Gaussian blobs
    (peak ~1) that lies inside a cone beam's field of view: centres in the
    middle half of the plane and at least 3 slices from the slab's ends
    (mid-slab in a slab thinner than 6),
    in-plane widths N/26..N/8.5, axial width 3 slices.  Frame ``m`` is
    frame 0 scaled by ``1 - 0.1 m`` so the time axis carries signal."""
    Nz, M, N, _ = vol_shape
    z = np.arange(Nz, dtype=np.float32)[:, None, None]
    r = np.arange(N, dtype=np.float32)[None, :, None]
    c = np.arange(N, dtype=np.float32)[None, None, :]
    img = np.zeros((Nz, N, N), np.float32)
    rng = np.random.default_rng(seed)
    z_lo = min(3.0, Nz / 2)
    for _ in range(n_blobs):
        z0 = rng.uniform(z_lo, max(Nz - 3, z_lo))
        r0, c0 = rng.uniform(N / 4, 3 * N / 4, size=2)
        w = rng.uniform(N / 25.6, N / 8.5)
        img += (np.exp(-((z - z0) / 3.0) ** 2)
                * np.exp(-((r - r0) / w) ** 2)
                * np.exp(-((c - c0) / w) ** 2))
    scale = 1.0 - 0.1 * np.arange(M, dtype=np.float32)
    return (img[:, None] * scale[None, :, None, None]).astype(np.float32)


def as_volume(img2d: np.ndarray, Nz: int = 1, M: int = 1) -> np.ndarray:
    """Tile a 2D image into the canonical ``(Nz, M, N_row, N_col)`` layout."""
    return np.broadcast_to(img2d, (Nz, M) + img2d.shape).copy()
