"""Denoising model front-ends over the solver layer.

Covers the reference's worked examples (``README.md:95-158``,
``examples/a_getting_started.ipynb``) as library API, plus the
``denoise_tv_chambolle`` scikit-image-compatible entry point the reference
lists as a to-do (``README.md:260``).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import TVConfig
from ..solvers.admm import admm
from ..solvers.cp import chambolle_pock
from ..solvers.fista import fista
from ..solvers.gd import subgradient_descent
from ..solvers.tgv import tgv_denoise


def add_noise(img, noise_level: float = 100.0, seed: int = 0) -> np.ndarray:
    """The README's noise recipe (``README.md:112-115``):
    ``img + noise_level * U[0,1)`` with ``np.random.seed(seed)``."""
    np.random.seed(seed)
    img = np.asarray(img, dtype=np.float64)
    return img + noise_level * np.random.rand(*img.shape)


def _to_volume(image):
    image = jnp.asarray(image)
    if image.ndim == 2:
        return image[None, None], 2
    if image.ndim == 3:  # z-stack
        return image[:, None], 3
    if image.ndim == 4:
        return image, 4
    raise ValueError(f"expected 2D/3D/4D image, got shape {image.shape}")


def _from_volume(x, ndim):
    if ndim == 2:
        return x[0, 0]
    if ndim == 3:
        return x[:, 0]
    return x


@dataclasses.dataclass(frozen=True)
class TVDenoiser:
    """TV denoising model: minimize ``1/2 ||x - x0||^2 + reg * TV(x)``.

    One object, three solvers (``README.md:107-158``'s GD and CP recipes plus
    ADMM).  Accepts 2D ``(N, N)``, 3D ``(Nz, N, N)`` or 4D ``(Nz, M, N, N)``
    inputs and returns the same rank.
    """

    reg: float = 25.0
    cfg: TVConfig = TVConfig()

    def gd(self, noisy, n_iter: int = 300, step_size: float = 5e-3, **kw):
        x, ndim = _to_volume(noisy)
        res = subgradient_descent(
            x, n_iter=n_iter, reg=self.reg, step_size=step_size, cfg=self.cfg, **kw
        )
        return res._replace(x=_from_volume(res.x, ndim))

    def cp(self, noisy, n_iter: int = 300, **kw):
        x, ndim = _to_volume(noisy)
        res = chambolle_pock(x, n_iter=n_iter, reg=self.reg, cfg=self.cfg, **kw)
        return res._replace(x=_from_volume(res.x, ndim))

    def admm(self, noisy, n_iter: int = 100, **kw):
        x, ndim = _to_volume(noisy)
        res = admm(x, n_iter=n_iter, reg=self.reg, cfg=self.cfg, **kw)
        return res._replace(x=_from_volume(res.x, ndim))

    def fista(self, noisy, n_iter: int = 100, **kw):
        x, ndim = _to_volume(noisy)
        res = fista(x, n_iter=n_iter, reg=self.reg, cfg=self.cfg, **kw)
        return res._replace(x=_from_volume(res.x, ndim))

    def tgv(self, noisy, n_iter: int = 300, alpha0: float = None, **kw):
        """Second-order TGV denoising (``solvers.tgv``): ``reg`` plays
        alpha1; ``alpha0`` defaults to ``2 * reg`` (the customary ratio).
        Fixes TV's staircasing on piecewise-linear content."""
        x, ndim = _to_volume(noisy)
        res = tgv_denoise(x, n_iter=n_iter, alpha1=self.reg,
                          alpha0=2.0 * self.reg if alpha0 is None else alpha0,
                          **kw)
        return res._replace(x=_from_volume(res.x, ndim))


@functools.partial(jax.jit,
                   static_argnames=("n_iter", "cfg", "compute_loss"))
def _cp_vectorial_run(x0, carry, weight, n_iter: int, cfg: TVConfig,
                      compute_loss: bool):
    """Jitted VECTORIAL (channel-coupled) TV CP scan on a channel stack
    ``(C, Nz, M, Nr, Nc)``:

        min_x 1/2 sum_c ||x_c - x0_c||^2
              + weight * sum_pixels sqrt(sum_c sum_d D(x_c)_d^2)

    — scikit-image's multichannel semantics: one joint per-pixel norm over
    channels AND difference directions, so edges are encouraged to align
    across channels.  K = blockdiag(D, ..., D) has the same operator norm
    as one D, so the reference step rule applies unchanged; the dual prox
    pools over the (channel, direction) group.  Module-level jit with a
    TRACED weight: repeated calls share one executable.  ``carry=None``
    starts fresh; pass the returned carry to continue (eps chunking).
    ``compute_loss=False`` skips the objective (nothing is wasted when the
    history is not consumed)."""
    from ..ops.operators import D, D_T
    from ..solvers.cp import default_tau

    kw = cfg.kwargs()
    sigma_D, sigma_A = 0.5, 1.0
    tau = default_tau(cfg, x0.shape[1], x0.shape[2], sigma_A)
    D_c = jax.vmap(lambda v: D(v, cfg.scheme, **kw))
    D_T_c = jax.vmap(lambda y: D_T(y, cfg.scheme, **kw))

    def step(carry, _):
        x, y_A, y_D = carry
        y_A = (y_A + sigma_A * (x - x0)) / (1.0 + sigma_A)
        D_x = D_c(x)
        p = y_D + sigma_D * D_x
        # joint per-pixel norm over channels (axis 0) and directions
        # (axis 2 of the (C, Nz, Nd, M, Nr, Nc) stack)
        nrm = jnp.sqrt(jnp.sum(jnp.square(p), axis=(0, 2), keepdims=True))
        y_D = p / jnp.maximum(1.0, nrm / weight)
        x = x - tau * y_A - tau * D_T_c(y_D)
        if compute_loss:
            tv = jnp.sum(jnp.sqrt(jnp.sum(jnp.square(D_x), axis=(0, 2))))
            loss = 0.5 * jnp.sum(jnp.square(x - x0)) + weight * tv
        else:
            loss = jnp.zeros((), x.dtype)
        return (x, y_A, y_D), loss

    if carry is None:
        carry = (x0, jnp.zeros_like(x0), jnp.zeros_like(D_c(x0)))
    return jax.lax.scan(step, carry, length=n_iter)


def _cp_vectorial(stack, weight, n_iter, cfg: TVConfig, eps=None):
    """Front door of :func:`_cp_vectorial_run`: one fixed-length scan, or
    eps-chunked early stopping (relative objective change per chunk)."""
    x0 = jnp.asarray(stack)
    if eps is None:
        (x, _, _), _ = _cp_vectorial_run(x0, None, weight, int(n_iter),
                                         cfg, False)
        return x
    carry = None
    done = 0
    chunk = min(20, int(n_iter))
    while done < n_iter:
        n = min(chunk, int(n_iter) - done)
        carry, losses = _cp_vectorial_run(x0, carry, weight, n, cfg, True)
        done += n
        l = np.asarray(losses)
        if abs(float(l[0]) - float(l[-1])) <= eps * abs(float(l[-1])):
            break
    return carry[0]


def denoise_tv_chambolle(
    image,
    weight: float = 0.1,
    eps: float = None,
    max_num_iter: int = 200,
    scheme: str = "hybrid",
    channel_axis: int = None,
    coupled_channels: bool = False,
):
    """scikit-image-compatible TV denoising (the reference's to-do item,
    ``README.md:260``): minimizes ``1/2 ||x - x0||^2 + weight * TV(x)`` with
    the Chambolle-Pock solver and returns a numpy array of the input rank.

    ``eps`` (scikit-image's stopping tolerance): when given, the solve runs
    in chunks and stops once the relative objective change over a chunk
    falls below ``eps`` (or at ``max_num_iter``).  Default ``None`` runs
    exactly ``max_num_iter`` iterations — one compiled scan, the fastest
    form on an accelerator (scikit-image's own default is ``eps=2e-4``).

    ``channel_axis`` (scikit-image convention) marks an axis of channels:
    2D multichannel ``(H, W, C)``-style or 3D z-stack multichannel.  By
    default channels are INDEPENDENT (per-channel TV, the reference
    library's semantics for uncoupled frames), riding one device-resident
    solve on a decoupled volume axis.  ``coupled_channels=True`` switches
    to scikit-image's VECTORIAL TV — one joint per-pixel norm over
    channels and directions (edges align across channels;
    :func:`_cp_vectorial`).
    """
    if coupled_channels and channel_axis is None:
        raise ValueError("coupled_channels=True requires channel_axis")

    def solve(vol, cfg):
        if eps is None:
            return chambolle_pock(jnp.asarray(vol), n_iter=max_num_iter,
                                  reg=weight, cfg=cfg)
        from ..solvers.state import run_until_converged

        return run_until_converged(
            chambolle_pock, jnp.asarray(vol), tol=eps,
            chunk=min(20, max_num_iter), max_iter=max_num_iter,
            reg=weight, cfg=cfg,
        )

    if channel_axis is None:
        vol, ndim = _to_volume(image)
        res = solve(vol, TVConfig(scheme=scheme))
        return np.asarray(_from_volume(res.x, ndim))

    img = np.asarray(image)
    ch_first = np.moveaxis(img, channel_axis, 0)
    if coupled_channels:
        if ch_first.ndim == 3:   # (C, H, W) -> channel stack of 2D volumes
            stack = ch_first[:, None, None]
        elif ch_first.ndim == 4:  # (C, Nz, H, W) -> z-coupled volumes
            stack = ch_first[:, :, None]
        else:
            raise ValueError(
                f"channel_axis given but image has rank {img.ndim}; "
                f"expected 3 or 4"
            )
        x = _cp_vectorial(jnp.asarray(stack), weight, max_num_iter,
                          TVConfig(scheme=scheme), eps=eps)
        out = np.asarray(x).reshape(ch_first.shape)
        return np.moveaxis(out, 0, channel_axis)
    if ch_first.ndim == 3:       # 2D multichannel: channels -> decoupled z
        vol = ch_first[:, None]  # (C, 1, H, W)
        res = solve(vol, TVConfig(scheme=scheme, reg_z_over_reg=0.0))
        out = np.asarray(res.x)[:, 0]
    elif ch_first.ndim == 4:     # 3D z-stack multichannel: channels -> t
        vol = np.moveaxis(ch_first, 0, 1)  # (Nz, C, H, W), reg_time=0
        res = solve(vol, TVConfig(scheme=scheme))
        out = np.moveaxis(np.asarray(res.x), 1, 0)
    else:
        raise ValueError(
            f"channel_axis given but image has rank {img.ndim}; expected 3 "
            f"(2D multichannel) or 4 (3D z-stack multichannel)"
        )
    return np.moveaxis(out, 0, channel_axis)
