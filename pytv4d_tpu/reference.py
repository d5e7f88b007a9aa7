"""Plain NumPy float64 reference recipes of the solvers.

Each loop restates one solver's update rules in NumPy on the reference
operators (``ops.operators`` / ``ops.tv`` with ``xp=numpy`` — the code
behind ``tv_operators_CPU`` and ``tv_CPU``), independent of the jitted
``lax.scan`` solvers.  The tests and ``chip_smoke.py`` compare the device
solvers against them.
"""

import numpy as np

from .core.schemes import operator_norm_bound_sq
from .ops import operators as ops
from .ops import tv as tv_mod


def D(x, cfg, mask_static=None, weight_time=None):
    return ops.D(np.asarray(x, np.float64), cfg.scheme,
                 mask_static=mask_static, weight_time=weight_time, xp=np,
                 **cfg.kwargs())


def D_T(y, cfg, mask_static=None, weight_time=None):
    return ops.D_T(np.asarray(y, np.float64), cfg.scheme,
                   mask_static=mask_static, weight_time=weight_time, xp=np,
                   **cfg.kwargs())


def tv_norm(d, norm, delta):
    if norm == "aniso":
        return float(np.sum(np.abs(d)))
    n = np.sqrt(np.sum(d * d, axis=1))
    if norm == "huber":
        return float(np.sum(np.where(n <= delta, n * n / (2 * delta),
                                     n - delta / 2)))
    return float(np.sum(n))


def dual_prox(p, reg, norm, sigma, delta):
    if norm == "aniso":
        return np.clip(p, -reg, reg)
    if norm == "huber":
        p = p / (1.0 + sigma * delta / reg)
    n = np.sqrt(np.sum(p * p, axis=1, keepdims=True))
    return p / np.maximum(1.0, n / reg)


def fid_dual(y, ax, b, sigma, fidelity, w):
    if fidelity == "l1":
        return np.clip(y + sigma * (ax - b), -w, w)
    if fidelity == "kl":
        q = y + sigma * ax
        return 0.5 * (q + w - np.sqrt((q - w) ** 2 + 4 * sigma * w * b))
    return (y + sigma * (ax - b)) / (1.0 + sigma / w)


def fid_loss(ax, b, fidelity, w):
    if fidelity == "l1":
        return float(np.sum(w * np.abs(ax - b)))
    if fidelity == "kl":
        ent = np.where(b > 0, b * np.log(np.maximum(b, 1e-30)
                                         / np.maximum(ax, 1e-30)), 0.0)
        return float(np.sum(w * (ax - b + ent)))
    return float(0.5 * np.sum(w * (ax - b) ** 2))


def chambolle_pock(x0, n_iter, reg, cfg, sigma_D=0.5, sigma_A=1.0, tau=None,
                   mask_static=None, weight_time=None, fidelity="l2",
                   fidelity_weight=1.0, nonneg=False):
    """The README CP recipe (``solvers.cp.cp_step`` semantics, including
    the loss line's pre-update ``D x``).  Returns ``(x, losses)``."""
    x0 = np.asarray(x0, np.float64)
    Nz, M = x0.shape[:2]
    if tau is None:
        tau = 1.0 / (operator_norm_bound_sq(cfg.scheme, Nz, M,
                                            cfg.reg_z_over_reg, cfg.reg_time)
                     + sigma_A)
    kw = dict(mask_static=mask_static, weight_time=weight_time)
    x = x0.copy()
    y_A = np.zeros_like(x0)
    y_D = np.zeros_like(D(x0, cfg, **kw))
    losses = []
    for _ in range(n_iter):
        y_A = fid_dual(y_A, x, x0, sigma_A, fidelity, fidelity_weight)
        Dx = D(x, cfg, **kw)
        y_D = dual_prox(y_D + sigma_D * Dx, reg, cfg.norm, sigma_D,
                        cfg.huber_delta)
        x = x - tau * y_A - tau * D_T(y_D, cfg, **kw)
        if nonneg:
            x = np.maximum(x, 0.0)
        losses.append(fid_loss(x, x0, fidelity, fidelity_weight)
                      + reg * tv_norm(Dx, cfg.norm, cfg.huber_delta))
    return x, np.asarray(losses)


def subgradient_descent(x0, n_iter, reg, step_size, cfg, mask_static=None,
                        weight_time=None):
    """The README GD recipe on the NumPy ``tv_and_subgrad``."""
    x0 = np.asarray(x0, np.float64)
    x = x0.copy()
    losses = []
    for _ in range(n_iter):
        tv, G = tv_mod.tv_and_subgrad(
            x, cfg.scheme, mask_static=mask_static, weight_time=weight_time,
            norm_type=cfg.norm, huber_delta=cfg.huber_delta, xp=np,
            **cfg.kwargs())
        x = x - step_size * ((x - x0) + reg * G)
        losses.append(0.5 * float(np.sum((x - x0) ** 2)) + reg * float(tv))
    return x, np.asarray(losses)


def cp_inverse(A, A_T, b, vol_shape, n_iter, reg, cfg, op_norm,
               fidelity="l2", fidelity_weight=1.0, nonneg=False):
    """Over-relaxed CP on ``K = [A; D]`` with ``tau = sigma =
    1/sqrt(||A||^2 + ||D||^2)`` (``solvers.inverse.cp_inverse``), applying
    ``A`` to the over-relaxed iterate directly."""
    b = np.asarray(b, np.float64)
    step = 1.0 / np.sqrt(op_norm ** 2 + operator_norm_bound_sq(
        cfg.scheme, vol_shape[0], vol_shape[1], cfg.reg_z_over_reg,
        cfg.reg_time))
    x = np.zeros(vol_shape)
    x_bar = x.copy()
    y_A = np.zeros_like(b)
    y_D = np.zeros_like(D(x, cfg))
    losses = []
    for _ in range(n_iter):
        y_A = fid_dual(y_A, A(x_bar), b, step, fidelity, fidelity_weight)
        y_D = dual_prox(y_D + step * D(x_bar, cfg), reg, cfg.norm, step,
                        cfg.huber_delta)
        x_new = x - step * (A_T(y_A) + D_T(y_D, cfg))
        if nonneg:
            x_new = np.maximum(x_new, 0.0)
        x_bar = 2.0 * x_new - x
        x = x_new
        losses.append(fid_loss(A(x), b, fidelity, fidelity_weight)
                      + reg * tv_norm(D(x, cfg), cfg.norm, cfg.huber_delta))
    return x, np.asarray(losses)
