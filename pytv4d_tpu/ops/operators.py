"""TV gradient operators D / D_T and the L2,1 norm — backend-agnostic core.

One implementation, generated from the declarative stencil tables in
``core/schemes.py``, replaces the reference's 18 hand-unrolled operator
functions (``pytv/tv_operators_CPU.py:45-658``, ``pytv/tv_operators_GPU.py``).
The array module is pluggable (``xp`` = ``jax.numpy`` or ``numpy``):

- ``xp=jax.numpy`` (default): jit-able, differentiable, shardable over a device mesh.  All
  code is pads/slices/elementwise only — no scatter ops — so XLA's SPMD
  partitioner can split it over a device mesh with automatic halo exchange.
- ``xp=numpy``: bit-exact float64 reference-parity path (used by the compat
  modules and the golden tests; reproduces ``README.md:91``'s
  532166.8251801673 to the last ulp).

Semantics matched to the reference (SURVEY.md section 2.2):

- input layout ``(Nz, M, N_row, N_col)``; D output ``(Nz, Nd, M, N_row, N_col)``
  (``pytv/tv_operators_CPU.py:97``).  Non-square images are supported (the
  reference's own to-do, ``README.md:259``).
- one-sided zero boundary convention (``tv_operators_CPU.py:115-127``).
- z/t channels pre-scaled by sqrt(reg) in both D and D_T
  (``tv_operators_CPU.py:133,143,419``).
- static-mask factor on time channels: applied to channel values in D
  (``tv_operators_CPU.py:148-151``) and to the accumulated time update after
  the scatter in D_T (``tv_operators_CPU.py:430-446``) — exactly as the
  reference orders it.
- scheme normalizations: hybrid 1/sqrt(2), central 1/2
  (``tv_operators_CPU.py:154,358,448,658``).
"""

from __future__ import annotations

import functools
import math

import jax.numpy as jnp

from ..core.schemes import (
    BWD,
    CTR,
    FWD,
    channel_weight,
    scheme_channels,
)

__all__ = [
    "compute_L21_norm",
    "D",
    "D_T",
    "D_upwind",
    "D_downwind",
    "D_central",
    "D_hybrid",
    "D_T_upwind",
    "D_T_downwind",
    "D_T_central",
    "D_T_hybrid",
]


def mask_enabled(mask_static) -> bool:
    """The reference's "disabled" sentinel is any bool (``tv_operators_CPU.py:148``:
    ``isinstance(mask_static, bool)``); we additionally accept None and []."""
    if mask_static is None or isinstance(mask_static, bool):
        return False
    if isinstance(mask_static, (list, tuple)) and len(mask_static) == 0:
        return False
    return True


def check_volume(img, ndim: int = 4, what: str = "img"):
    """All operator entry points require the canonical rank — the reference
    silently assumes it and crashes confusingly otherwise (its GPU docstrings
    even claim 2D/3D input works, SURVEY.md section 2.4.7).  2D/3D images are
    handled by ``models.TVDenoiser`` / ``utils.as_volume``."""
    if img.ndim != ndim:
        expect = "(Nz, M, N_row, N_col)" if ndim == 4 else "(Nz, Nd, M, N_row, N_col)"
        raise ValueError(
            f"{what} must be rank {ndim} with layout {expect}, got shape "
            f"{tuple(img.shape)}; wrap 2D/3D images with utils.as_volume or "
            f"use models.TVDenoiser which accepts 2D/3D/4D"
        )


def _sl(ndim: int, axis: int, a, b):
    s = [slice(None)] * ndim
    s[axis] = slice(a, b)
    return tuple(s)


def _pad(xp, arr, axis: int, before: int, after: int):
    pads = [(0, 0)] * arr.ndim
    pads[axis] = (before, after)
    return xp.pad(arr, pads)


def d_channel(xp, img, axis: int, kind: str):
    """One unweighted difference channel with the zero-slot boundary convention.

    FWD: d[i] = f[i+1]-f[i] at slots [0, L-2]   (``tv_operators_CPU.py:265``)
    BWD: d[i] = f[i]-f[i-1] at slots [1, L-1]   (``tv_operators_CPU.py:199``)
    CTR: d[i] = f[i+1]-f[i-1] at slots [1, L-2] (``tv_operators_CPU.py:331``)
    """
    nd = img.ndim
    if kind == CTR:
        d = img[_sl(nd, axis, 2, None)] - img[_sl(nd, axis, None, -2)]
        return _pad(xp, d, axis, 1, 1)
    d = img[_sl(nd, axis, 1, None)] - img[_sl(nd, axis, None, -1)]
    if kind == FWD:
        return _pad(xp, d, axis, 0, 1)
    return _pad(xp, d, axis, 1, 0)


def dt_channel(xp, y, axis: int, kind: str):
    """Exact adjoint scatter of one channel.

    Reads only the channel's valid slots (the reference ignores values parked
    in zero slots, e.g. ``tv_operators_CPU.py:555-556`` reads ``img[:,0,:,:-1,:]``)
    and scatter-adds with opposite signs:

    FWD: out[i+1] += y[i], out[i]   -= y[i]  for i in [0, L-2]
    BWD: out[i]   += y[i], out[i-1] -= y[i]  for i in [1, L-1]
    CTR: out[i+1] += y[i], out[i-1] -= y[i]  for i in [1, L-2]

    Expressed as pads (no scatter primitive) so XLA shards it automatically.
    """
    nd = y.ndim
    if kind == FWD:
        t = y[_sl(nd, axis, None, -1)]
        return _pad(xp, t, axis, 1, 0) - _pad(xp, t, axis, 0, 1)
    if kind == BWD:
        t = y[_sl(nd, axis, 1, None)]
        return _pad(xp, t, axis, 1, 0) - _pad(xp, t, axis, 0, 1)
    t = y[_sl(nd, axis, 1, -1)]
    return _pad(xp, t, axis, 2, 0) - _pad(xp, t, axis, 0, 2)


def abs_d_channel(xp, img, axis: int, kind: str):
    """|D| row pattern: like :func:`d_channel` but summing |entries|
    (x[i+1] + x[i] instead of the difference) — used for diagonal
    preconditioning (Pock & Chambolle 2011, doi 10.1109/ICCV.2011.6126441)."""
    nd = img.ndim
    if kind == CTR:
        s = img[_sl(nd, axis, 2, None)] + img[_sl(nd, axis, None, -2)]
        return _pad(xp, s, axis, 1, 1)
    s = img[_sl(nd, axis, 1, None)] + img[_sl(nd, axis, None, -1)]
    if kind == FWD:
        return _pad(xp, s, axis, 0, 1)
    return _pad(xp, s, axis, 1, 0)


def abs_dt_channel(xp, y, axis: int, kind: str):
    """|D^T| column pattern: scatter of |entries| (both signs +)."""
    nd = y.ndim
    if kind == FWD:
        t = y[_sl(nd, axis, None, -1)]
        return _pad(xp, t, axis, 1, 0) + _pad(xp, t, axis, 0, 1)
    if kind == BWD:
        t = y[_sl(nd, axis, 1, None)]
        return _pad(xp, t, axis, 1, 0) + _pad(xp, t, axis, 0, 1)
    t = y[_sl(nd, axis, 1, -1)]
    return _pad(xp, t, axis, 2, 0) + _pad(xp, t, axis, 0, 2)


def precond_maps(
    shape,
    scheme: str = "hybrid",
    reg_z_over_reg: float = 1.0,
    reg_time: float = 0.0,
    sigma_A_rows: float = 1.0,
    *,
    fidelity_colsum=None,
    grouped: bool = False,
    xp=jnp,
):
    """Diagonal preconditioners for CP on ``K = [A; D]`` (alpha = 1):
    per-dual-slot ``sigma = 1/sum_i |K_ji|`` and per-pixel
    ``tau = 1/sum_j |K_ji|`` — dead dual slots get sigma = 0 (they carry
    no information and stay at zero).  The fidelity block's column sums
    default to the scalar ``sigma_A_rows`` (``A = I`` denoising); for a
    general forward operator pass ``fidelity_colsum = |A|^T 1`` — exact
    whenever A has nonnegative coefficients (the CT projectors, blurs and
    masks here), where ``|A|^T 1 = A^T 1``.  Returns
    (sigma_D_map, tau_map)."""
    Nz, M = shape[0], shape[1]
    chans, norm = scheme_channels(scheme, Nz, M, reg_z_over_reg, reg_time)
    ones = xp.ones(shape)
    row_sums = []
    col_sum = None
    for ch in chans:
        w = abs(channel_weight(ch, reg_z_over_reg, reg_time)) * norm
        rs = abs_d_channel(xp, ones, ch.axis, ch.kind) * w
        row_sums.append(rs)
        # |D^T| column contribution: scatter |w| over the channel's valid slots
        valid = xp.where(rs > 0, xp.ones_like(rs), xp.zeros_like(rs))
        cs = abs_dt_channel(xp, valid, ch.axis, ch.kind) * w
        col_sum = cs if col_sum is None else col_sum + cs
    rows = xp.stack(row_sums, axis=1)
    if grouped:
        # one step per pixel GROUP (the iso/Huber channel-group prox is
        # exact only for a scalar step per group): the group minimum of
        # the per-channel bounds = 1/max(row sums) — below every row-sum
        # bound, so the Pock-Chambolle step condition still holds
        gmax = xp.max(rows, axis=1, keepdims=True)
        sigma_D = xp.where(gmax > 0, 1.0 / xp.where(gmax > 0, gmax, 1.0),
                           0.0)
    else:
        sigma_D = xp.where(rows > 0, 1.0 / xp.where(rows > 0, rows, 1.0),
                           0.0)
    fid = sigma_A_rows if fidelity_colsum is None else fidelity_colsum
    den = col_sum + fid
    tau = 1.0 / xp.where(den > 0, den, 1.0)
    return sigma_D, tau


def compute_L11_norm(D_img, return_array: bool = False, *, xp=jnp):
    """Anisotropic L1,1 norm of a difference image: sum |D| (framework
    extension; the reference is isotropic-only).  ``return_array`` gives the
    per-pixel sum of |channels| for symmetry with :func:`compute_L21_norm`."""
    out = xp.sum(xp.abs(D_img), axis=1)
    total = xp.sum(out)
    if return_array:
        return total, out
    return total


def tv_norm(D_img, norm: str = "iso", return_array: bool = False,
            huber_delta: float = 1.0, *, xp=jnp):
    """The TV reduction for any norm type ('iso', 'aniso', 'huber')."""
    if norm == "aniso":
        return compute_L11_norm(D_img, return_array=return_array, xp=xp)
    if norm == "huber":
        return compute_huber_norm(D_img, huber_delta,
                                  return_array=return_array, xp=xp)
    return compute_L21_norm(D_img, return_array=return_array, xp=xp)


def compute_huber_norm(D_img, delta: float, return_array: bool = False, *,
                       xp=jnp):
    """Huber-smoothed L2,1 norm: per-pixel gradient magnitude n = |D[i,:]|_2
    scored ``n^2/(2 delta)`` below ``delta`` and ``n - delta/2`` above —
    the Moreau envelope of the isotropic TV (quadratic near 0, so
    differentiable everywhere; Chambolle & Pock 2011 section 6.2).
    Optionally also returns the per-pixel magnitude array."""
    n = _safe_sqrt(xp.sum(xp.square(D_img), axis=1), xp)
    val = xp.sum(xp.where(n <= delta, xp.square(n) / (2.0 * delta),
                          n - delta / 2.0))
    if return_array:
        return val, n
    return val


def _safe_sqrt(s, xp):
    """sqrt with a finite gradient at 0 (double-where): the primal is
    bit-identical to ``sqrt`` for s >= 0 (0 -> 0) and still propagates
    NaNs, but the VJP at s == 0 is 0 instead of ``0 * inf = nan`` — this
    is what makes the solvers differentiable through their loss lines at
    flat pixels (unrolled hyperparameter gradients)."""
    zero = s == 0
    return xp.where(zero, 0.0, xp.sqrt(xp.where(zero, 1.0, s)))


def compute_L21_norm(D_img, return_array: bool = False, *, xp=jnp):
    """L2,1 norm of a difference image: sum_i sqrt(sum_j D[i,j]^2).

    Mirrors ``pytv/tv_operators_CPU.py:45-74``: square, sum over the channel
    axis (axis 1), sqrt, global sum; optionally also returns the
    ``(Nz, M, N_row, N_col)`` array of per-pixel L2 norms.
    """
    out = xp.square(D_img)
    out = xp.sum(out, axis=1)
    out = _safe_sqrt(out, xp)
    l21 = xp.sum(out)
    if return_array:
        return l21, out
    return l21


def D(
    img,
    scheme: str = "hybrid",
    reg_z_over_reg: float = 1.0,
    reg_time: float = 0.0,
    mask_static=False,
    factor_reg_static: float = 0.0,
    weight_time=None,
    *,
    xp=jnp,
):
    """Discrete gradient operator; output ``(Nz, Nd, M, N_row, N_col)``.

    Parity: ``pytv/tv_operators_CPU.py:76-358`` (all four ``D_<scheme>``).

    ``weight_time``: per-pixel weight matrix (broadcastable to
    ``(Nz, M, N_row, N_col)``) multiplying the time channels — the
    reference's own to-do (``README.md:258``: "replace mask_static,
    factor_reg_static with a weight matrix ... passed directly onto all
    functions").  Applied symmetrically in :func:`D_T` (pre-scatter) so
    D/D_T stay exactly adjoint for ANY weight field, unlike the
    mask_static path which replicates the reference's post-scatter
    ordering.
    """
    check_volume(img)
    Nz, M = img.shape[0], img.shape[1]
    chans, norm = scheme_channels(scheme, Nz, M, reg_z_over_reg, reg_time)
    use_mask = mask_enabled(mask_static)
    sqrt_factor = math.sqrt(factor_reg_static) if use_mask else 1.0

    outs = []
    for ch in chans:
        d = d_channel(xp, img, ch.axis, ch.kind)
        w = channel_weight(ch, reg_z_over_reg, reg_time)
        if w != 1.0:
            d = d * w
        if ch.weight == "t":
            if use_mask:
                d = xp.where(mask_static, d * sqrt_factor, d)
            if weight_time is not None:
                d = d * weight_time
        outs.append(d)
    D_img = xp.stack(outs, axis=1)
    if norm != 1.0:
        D_img = D_img * norm
    return D_img


def D_T(
    D_img,
    scheme: str = "hybrid",
    reg_z_over_reg: float = 1.0,
    reg_time: float = 0.0,
    mask_static=False,
    factor_reg_static: float = 0.0,
    weight_time=None,
    *,
    xp=jnp,
):
    """Exact transpose of :func:`D`; output ``(Nz, M, N_row, N_col)``.

    Parity: ``pytv/tv_operators_CPU.py:360-658`` (all four ``D_T_<scheme>``).
    The static-mask factor is applied to the *accumulated time update* after
    the scatter, exactly as the reference does (``tv_operators_CPU.py:430-446``).
    """
    check_volume(D_img, 5, "D_img")
    Nz, M = D_img.shape[0], D_img.shape[2]
    chans, norm = scheme_channels(scheme, Nz, M, reg_z_over_reg, reg_time)
    if D_img.shape[1] != len(chans):
        raise ValueError(
            f"D_img has {D_img.shape[1]} channels but scheme {scheme!r} with "
            f"Nz={Nz}, M={M}, reg_z_over_reg={reg_z_over_reg}, "
            f"reg_time={reg_time} expects {len(chans)}"
        )
    use_mask = mask_enabled(mask_static)
    sqrt_factor = math.sqrt(factor_reg_static) if use_mask else 1.0

    out = None
    out_time = None
    for i, ch in enumerate(chans):
        y = D_img[:, i]
        w = channel_weight(ch, reg_z_over_reg, reg_time)
        if w != 1.0:
            y = y * w
        if ch.weight == "t" and weight_time is not None:
            # pre-scatter (exact transpose of D's weighting)
            y = y * weight_time
        contrib = dt_channel(xp, y, ch.axis, ch.kind)
        if use_mask and ch.weight == "t":
            out_time = contrib if out_time is None else out_time + contrib
        else:
            out = contrib if out is None else out + contrib
    if out is None:
        out = xp.zeros(
            (Nz, M, D_img.shape[3], D_img.shape[4]), dtype=D_img.dtype
        )
    if out_time is not None:
        out_time = xp.where(mask_static, out_time * sqrt_factor, out_time)
        out = out + out_time
    if norm != 1.0:
        out = out * norm
    return out


def _scheme_partial(fn, scheme):
    partial = functools.partial(fn, scheme=scheme)
    partial.__name__ = f"{fn.__name__}_{scheme}"
    partial.__qualname__ = partial.__name__
    partial.__doc__ = f"{fn.__name__}(..., scheme={scheme!r}); see :func:`{fn.__name__}`."
    return partial


D_upwind = _scheme_partial(D, "upwind")
D_downwind = _scheme_partial(D, "downwind")
D_central = _scheme_partial(D, "central")
D_hybrid = _scheme_partial(D, "hybrid")
D_T_upwind = _scheme_partial(D_T, "upwind")
D_T_downwind = _scheme_partial(D_T, "downwind")
D_T_central = _scheme_partial(D_T, "central")
D_T_hybrid = _scheme_partial(D_T, "hybrid")
