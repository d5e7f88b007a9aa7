"""Second-order Total Generalized Variation (TGV-2) denoising — the standard
fix for first-order TV's staircasing artifact (Bredies, Kunisch & Pock 2010,
doi:10.1137/090769521; retrieval pointer: "Modular proximal optimization for
multidimensional total-variation regularization", arXiv:1411.0589).

    min_{x, w} 1/2 ||x - x0||^2 + a1 ||D x - w||_{2,1} + a0 ||E w||_{2,1}

where ``D`` is the in-plane forward-difference gradient (the upwind scheme's
row/col channels, one-sided zero boundary exactly as the reference's TV
operators, ``tv_operators_CPU.py:222-286``) and ``E`` is the symmetrized
Jacobian of the 2-vector field ``w``.  On piecewise-LINEAR signals TGV
recovers the slope (w tracks the gradient) where TV produces staircases.

Scope: by default (``axes='2d'``) TGV acts in-plane per (z, t) slice,
batched over the canonical ``(Nz, M, N_row, N_col)`` volume — the classic
2D TGV applied slice-wise.  ``axes='3d'`` couples (z, row, col): ``w``
becomes a 3-field and ``E`` the 3x3 symmetrized Jacobian (6 channels), for
volumes that are piecewise-linear along z too.  ``axes='4d'`` additionally
couples time (4-field ``w``, 10-channel ``E``).  Solved with Chambolle-Pock
over K = [[D, -I], [0, E]]; ``E``'s exact adjoint comes from
``jax.linear_transpose``, so the adjointness contract holds to fp
precision by construction.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp


class TGVState(NamedTuple):
    """Full CP state for resume/checkpointing (public layouts: w-like
    fields are (Nz, n_w, M, Nr, Nc), q is (Nz, n_q, M, Nr, Nc))."""
    x: jax.Array
    xb: jax.Array
    w: jax.Array
    wb: jax.Array
    p: jax.Array
    q: jax.Array


class TGVInverseState(NamedTuple):
    """Full CP carry of :func:`tgv_inverse` for resume/checkpointing:
    primal x/w with their over-relaxed copies, the fidelity dual y_A, and
    the TGV duals p/q.  ``s_x``/``s_xb`` carry the forward projections
    ``A(x)``/``A(xb)`` so the linearity-derived over-relaxed projection
    (one forward per iteration, see ``solvers.inverse.InverseState``)
    resumes bit-exactly; ``None`` (old checkpoints) is recomputed once."""
    x: jax.Array
    xb: jax.Array
    w: jax.Array
    wb: jax.Array
    y_A: jax.Array
    p: jax.Array
    q: jax.Array
    s_x: Optional[jax.Array] = None
    s_xb: Optional[jax.Array] = None


class TGVResult(NamedTuple):
    x: jax.Array     # denoised volume (Nz, M, N_row, N_col)
    w: jax.Array     # auxiliary vector field (Nz, 2, M, N_row, N_col)
    loss: jax.Array  # primal objective history (n_iter,)
    state: NamedTuple = None  # TGVState (tgv_denoise) or TGVInverseState
                              # (tgv_inverse); resume via the state kwarg


def _d_fwd(x):
    """In-plane forward differences of (Nz, M, Nr, Nc) -> (Nz, 2, M, Nr, Nc)
    with the reference's one-sided zero boundary (last row/col = 0)."""
    dr = jnp.pad(x[:, :, 1:] - x[:, :, :-1], ((0, 0), (0, 0), (0, 1), (0, 0)))
    dc = jnp.pad(x[..., 1:] - x[..., :-1], ((0, 0), (0, 0), (0, 0), (0, 1)))
    return jnp.stack([dr, dc], axis=1)


def _sym_grad(w):
    """Symmetrized Jacobian of the 2-field w (Nz, 2, M, Nr, Nc) ->
    (Nz, 3, M, Nr, Nc): [d_r w_r, d_c w_c, (d_c w_r + d_r w_c)/2], backward
    differences with zero boundary at the first row/col (the discretization
    dual to ``_d_fwd``)."""
    wr, wc = w[:, 0], w[:, 1]

    def d_r(a):
        return jnp.pad(a[:, :, 1:] - a[:, :, :-1],
                       ((0, 0), (0, 0), (1, 0), (0, 0)))

    def d_c(a):
        return jnp.pad(a[..., 1:] - a[..., :-1],
                       ((0, 0), (0, 0), (0, 0), (1, 0)))

    return jnp.stack([d_r(wr), d_c(wc), 0.5 * (d_c(wr) + d_r(wc))], axis=1)


def _d_fwd3(x):
    """Volumetric forward differences (Nz, M, Nr, Nc) -> (Nz, 3, M, Nr, Nc)
    with components [z, row, col], zero at the far boundary."""
    dz = jnp.pad(x[1:] - x[:-1], ((0, 1), (0, 0), (0, 0), (0, 0)))
    dr = jnp.pad(x[:, :, 1:] - x[:, :, :-1], ((0, 0), (0, 0), (0, 1), (0, 0)))
    dc = jnp.pad(x[..., 1:] - x[..., :-1], ((0, 0), (0, 0), (0, 0), (0, 1)))
    return jnp.stack([dz, dr, dc], axis=1)


def _sym_grad3(w):
    """Symmetrized Jacobian of the 3-field w (Nz, 3, M, Nr, Nc) ->
    (Nz, 6, M, Nr, Nc): diagonals [d_z w_z, d_r w_r, d_c w_c] then
    off-diagonals [(d_r w_z + d_z w_r)/2, (d_c w_z + d_z w_c)/2,
    (d_c w_r + d_r w_c)/2]; backward differences, zero at the first slot."""
    wz, wr, wc = w[:, 0], w[:, 1], w[:, 2]

    def d_z(a):
        return jnp.pad(a[1:] - a[:-1], ((1, 0), (0, 0), (0, 0), (0, 0)))

    def d_r(a):
        return jnp.pad(a[:, :, 1:] - a[:, :, :-1],
                       ((0, 0), (0, 0), (1, 0), (0, 0)))

    def d_c(a):
        return jnp.pad(a[..., 1:] - a[..., :-1],
                       ((0, 0), (0, 0), (0, 0), (1, 0)))

    return jnp.stack([
        d_z(wz), d_r(wr), d_c(wc),
        0.5 * (d_r(wz) + d_z(wr)),
        0.5 * (d_c(wz) + d_z(wc)),
        0.5 * (d_c(wr) + d_r(wc)),
    ], axis=1)


def _d_fwd4(x):
    """Space-time forward differences (Nz, M, Nr, Nc) -> (Nz, 4, M, Nr, Nc)
    with components [z, t, row, col], zero at the far boundary."""
    dz = jnp.pad(x[1:] - x[:-1], ((0, 1), (0, 0), (0, 0), (0, 0)))
    dt = jnp.pad(x[:, 1:] - x[:, :-1], ((0, 0), (0, 1), (0, 0), (0, 0)))
    dr = jnp.pad(x[:, :, 1:] - x[:, :, :-1], ((0, 0), (0, 0), (0, 1), (0, 0)))
    dc = jnp.pad(x[..., 1:] - x[..., :-1], ((0, 0), (0, 0), (0, 0), (0, 1)))
    return jnp.stack([dz, dt, dr, dc], axis=1)


def _sym_grad4(w):
    """Symmetrized Jacobian of the 4-field w (Nz, 4, M, Nr, Nc) ->
    (Nz, 10, M, Nr, Nc): diagonals [d_z w_z, d_t w_t, d_r w_r, d_c w_c]
    then off-diagonals for the pairs (z,t), (z,r), (z,c), (t,r), (t,c),
    (r,c); backward differences, zero at the first slot."""
    wz, wt, wr, wc = w[:, 0], w[:, 1], w[:, 2], w[:, 3]

    def d(a, axis):
        pad = [(0, 0)] * 4
        pad[axis] = (1, 0)
        sl = [slice(None)] * 4
        lo, hi = list(sl), list(sl)
        lo[axis], hi[axis] = slice(1, None), slice(None, -1)
        return jnp.pad(a[tuple(lo)] - a[tuple(hi)], pad)

    fields = (wz, wt, wr, wc)
    diag = [d(f, i) for i, f in enumerate(fields)]
    off = [0.5 * (d(fields[i], j) + d(fields[j], i))
           for i in range(4) for j in range(i + 1, 4)]
    return jnp.stack(diag + off, axis=1)


def _proj_ball(p, radius):
    from ..ops.operators import _safe_sqrt

    n = _safe_sqrt(jnp.sum(jnp.square(p), axis=1, keepdims=True), jnp)
    return p / jnp.maximum(1.0, n / radius)


def _tgv_dual_prox(p, radius, norm, sigma, delta):
    """Prox of the conjugate of ``radius * N(.)`` for the TGV norm family
    (channel axis 1): iso L2,1 ball projection; aniso L1,1 box; Huber =
    shrink by ``1 + sigma*delta/radius`` then ball-project (the conjugate
    gains ``delta/(2 radius) |y|^2`` — same rule as solvers/cp.dual_prox).
    ``sigma`` may be a scalar or a per-slot map (preconditioned)."""
    if norm == "aniso":
        return jnp.clip(p, -radius, radius)
    if norm == "huber":
        p = p / (1.0 + sigma * delta / radius)
    return _proj_ball(p, radius)


def _tgv_norm_val(v, norm, delta):
    """The TGV term's norm value (channel axis 1): iso L2,1; aniso L1,1;
    Huber of the per-pixel channel 2-norm (ops.operators.compute_huber_norm
    convention).  Uses the safe sqrt so gradients stay finite at exactly
    flat pixels (ops.operators._safe_sqrt)."""
    from ..ops.operators import _safe_sqrt

    if norm == "aniso":
        return jnp.sum(jnp.abs(v))
    n = _safe_sqrt(jnp.sum(jnp.square(v), axis=1), jnp)
    if norm == "huber":
        return jnp.sum(jnp.where(n <= delta, jnp.square(n) / (2.0 * delta),
                                 n - delta / 2.0))
    return jnp.sum(n)


def tgv_denoise(
    x_noisy,
    n_iter: int = 300,
    alpha1: float = 25.0,
    alpha0: float = 50.0,
    sigma_tau_split: float = 1.0,
    axes: str = "2d",
    compute_loss: bool = True,
    loss_every: int = 0,
    state: TGVState = None,
    norm: str = "iso",
    huber_delta: float = 1.0,
) -> TGVResult:
    """TGV-2 denoising with Chambolle-Pock.  ``alpha1`` weighs first-order
    variation (like TV's reg), ``alpha0`` the second-order term — the usual
    choice is ``alpha0 = 2 * alpha1``.

    ``axes='2d'`` (default): in-plane TGV per (z, t) slice — step sizes use
    the exact 2D bound ``||K||^2 = 12 + sqrt(136)`` (Bredies et al. sec. 6).
    ``axes='3d'``: volumetric TGV coupling (z, row, col) — w is a 3-field,
    E the 3x3 symmetrized Jacobian (6 channels), steps from the conservative
    bound ``||K||^2 <= max(2 ||D||^2, 2 + ||E||^2) = 24``.
    ``axes='4d'``: full space-time coupling (z, t, row, col) — w is a
    4-field, E the 4x4 symmetrized Jacobian (10 channels), bound
    ``max(2*16, 2 + 10) = 32``; for volumes piecewise-linear along time
    too (e.g. steady motion between frames).

    ``compute_loss=False`` skips the per-iteration objective (which costs
    an extra ``D`` + ``E`` application per step); ``loss`` then comes back
    empty, shape ``(0,)``.  ``loss_every=k`` (k > 0, must divide
    ``n_iter``) instead SAMPLES the objective after every k-th iteration —
    ``loss`` has shape ``(n_iter // k,)`` — amortizing its cost to 1/k.

    ``state`` resumes a previous run from ``result.state`` (full CP state:
    x, x_bar, w, w_bar, p, q) — composes with ``run_until_converged`` and
    ``solvers.state`` checkpointing.

    Input must be the canonical 4D ``(Nz, M, N_row, N_col)`` volume
    (``models.TVDenoiser.tgv`` accepts 2D/3D and restores the rank)."""
    if hasattr(x_noisy, "ndim") and x_noisy.ndim != 4:
        raise ValueError(
            f"tgv_denoise expects a rank-4 (Nz, M, N_row, N_col) volume, got "
            f"shape {tuple(x_noisy.shape)}; use models.TVDenoiser(...).tgv "
            f"for 2D/3D inputs"
        )
    if axes not in ("2d", "3d", "4d"):
        raise ValueError(f"axes must be '2d', '3d' or '4d', got {axes!r}")
    if loss_every:
        if loss_every < 0 or n_iter % loss_every:
            raise ValueError(
                f"loss_every must be a positive divisor of n_iter, got "
                f"loss_every={loss_every} with n_iter={n_iter}"
            )
    if norm not in ("iso", "aniso", "huber"):
        raise ValueError(f"norm must be 'iso', 'aniso' or 'huber', got "
                         f"{norm!r}")
    return _tgv_denoise_impl(
        x_noisy, state, n_iter=n_iter, alpha1=alpha1, alpha0=alpha0,
        sigma_tau_split=sigma_tau_split, axes=axes,
        compute_loss=compute_loss, loss_every=loss_every,
        norm=norm, huber_delta=huber_delta,
    )


@functools.partial(
    jax.jit, static_argnames=("n_iter", "alpha1", "alpha0", "sigma_tau_split",
                              "axes", "compute_loss", "loss_every",
                              "norm", "huber_delta")
)
def _tgv_denoise_impl(x_noisy, state, *, n_iter, alpha1, alpha0,
                      sigma_tau_split, axes, compute_loss, loss_every,
                      norm="iso", huber_delta=1.0):
    x0 = jnp.asarray(x_noisy)
    if x0.ndim != 4:
        raise ValueError(
            f"tgv_denoise expects a rank-4 (Nz, M, N_row, N_col) volume, got "
            f"shape {tuple(x0.shape)}; use models.TVDenoiser(...).tgv for "
            f"2D/3D inputs"
        )
    dtype = x0.dtype

    d_fwd, sym_grad, d_T, sym_T, n_w, n_q, L_sq = _tgv_ops(
        axes, tuple(x0.shape), dtype)
    L = jnp.sqrt(jnp.asarray(L_sq)).astype(dtype)
    sigma = (sigma_tau_split / L).astype(dtype)
    tau = (1.0 / (sigma_tau_split * L)).astype(dtype)

    Nz, M, Nr, Nc = x0.shape
    if state is None:
        w0 = jnp.zeros((Nz, n_w, M, Nr, Nc), dtype)
        p0 = jnp.zeros_like(w0)                    # dual of (Dx - w)
        q0 = jnp.zeros((Nz, n_q, M, Nr, Nc), dtype)  # dual of (E w)
        init_jnp = (x0, x0, w0, w0, p0, q0)
    else:
        init_jnp = tuple(state)

    def _result_jnp(carry, losses):
        st = TGVState(*carry)
        return TGVResult(x=st.x, w=st.w, loss=losses, state=st)

    def step(carry, _):
        x, xb, w, wb, p, q = carry
        p = _tgv_dual_prox(p + sigma * (d_fwd(xb) - wb), alpha1, norm,
                           sigma, huber_delta)
        q = _tgv_dual_prox(q + sigma * sym_grad(wb), alpha0, norm,
                           sigma, huber_delta)
        x_new = (x - tau * d_T(p) + tau * x0) / (1.0 + tau)
        w_new = w - tau * (-p + sym_T(q))
        xb = 2.0 * x_new - x
        wb = 2.0 * w_new - w
        if compute_loss and not loss_every:
            loss = (0.5 * jnp.sum(jnp.square(x_new - x0))
                    + alpha1 * _tgv_norm_val(d_fwd(x_new) - w_new, norm,
                                             huber_delta)
                    + alpha0 * _tgv_norm_val(sym_grad(w_new), norm,
                                             huber_delta))
        else:
            loss = None
        return (x_new, xb, w_new, wb, p, q), loss

    if loss_every:
        def chunk(carry, _):
            carry = jax.lax.fori_loop(
                0, loss_every, lambda i, c: step(c, None)[0], carry)
            xc, _, wc, _, _, _ = carry
            loss = (0.5 * jnp.sum(jnp.square(xc - x0))
                    + alpha1 * _tgv_norm_val(d_fwd(xc) - wc, norm,
                                             huber_delta)
                    + alpha0 * _tgv_norm_val(sym_grad(wc), norm,
                                             huber_delta))
            return carry, loss

        carry, losses = jax.lax.scan(
            chunk, init_jnp, length=n_iter // loss_every
        )
        return _result_jnp(carry, losses)

    carry, losses = jax.lax.scan(step, init_jnp, length=n_iter)
    if losses is None:
        losses = jnp.zeros((0,), dtype)
    return _result_jnp(carry, losses)


def _transpose_of(fn, in_shape, dtype):
    """Exact adjoint of a linear map via jax.linear_transpose (adjointness
    to fp precision by construction — same contract as models.ct)."""
    primal = jax.ShapeDtypeStruct(tuple(in_shape), dtype)
    t = jax.linear_transpose(fn, primal)

    def fn_T(y):
        (x_bar,) = t(y)
        return x_bar

    return fn_T


# ||K_tgv||^2 bounds per axes mode: exact 2D (Bredies et al. sec. 6),
# conservative max(2||D||^2, 2 + ||E||^2) for the coupled modes
TGV_NORM_BOUND_SQ = {
    "2d": 12.0 + math.sqrt(136.0),
    "3d": 24.0,
    "4d": 32.0,
}


def _tgv_ops(axes: str, vol_shape, dtype):
    """(d_fwd, sym_grad, their adjoints, n_w, n_q, ||K_tgv||^2 bound) for an
    axes mode — the same table tgv_denoise uses."""
    if axes == "4d":
        d_fwd, sym_grad, n_w, n_q = _d_fwd4, _sym_grad4, 4, 10
    elif axes == "3d":
        d_fwd, sym_grad, n_w, n_q = _d_fwd3, _sym_grad3, 3, 6
    elif axes == "2d":
        d_fwd, sym_grad, n_w, n_q = _d_fwd, _sym_grad, 2, 3
    else:
        raise ValueError(f"axes must be '2d', '3d' or '4d', got {axes!r}")
    L_sq = TGV_NORM_BOUND_SQ[axes]
    Nz, M, Nr, Nc = vol_shape
    w_shape = (Nz, n_w, M, Nr, Nc)
    sym_T = _transpose_of(sym_grad, w_shape, dtype)
    d_T = _transpose_of(d_fwd, tuple(vol_shape), dtype)
    return d_fwd, sym_grad, d_T, sym_T, n_w, n_q, L_sq


def _axis_mask(vol_shape, dim, kind, dtype):
    """Boundary-validity mask broadcast over the volume: ``kind='ge1'`` is
    1 where index >= 1 along ``dim``; ``'lem2'`` is 1 where index <= N-2."""
    n = vol_shape[dim]
    idx = jnp.arange(n)
    m = (idx >= 1) if kind == "ge1" else (idx <= n - 2)
    shape = [1] * len(vol_shape)
    shape[dim] = n
    return m.astype(dtype).reshape(shape)


def _tgv_precond_maps(vol_shape, axes, dtype, norm="iso", A=None, A_T=None,
                      b_shape=None):
    """Pock-Chambolle (2011, alpha=1) diagonal preconditioners for
    K = [[A, 0], [D, -I], [0, E]] from EXACT row/column absolute sums:
    D/E stencils have coefficients +-1 and +-0.5 with known boundary
    structure, so their abs-sums are closed-form per-axis boundary masks;
    the CT projectors (and blur/masking operators) have NONNEGATIVE
    coefficients, so ``|A| 1 = A 1`` and ``|A|^T 1 = A^T 1`` exactly.

    Dual steps: for the separable ANISO norm, per-channel reciprocal row
    sums (lists of rank-4 broadcastable masks — exact prox per channel).
    For the GROUPED iso/Huber norms the channel-group ball/shrink prox is
    exact only with one step per pixel group, so sigma is the per-pixel
    group MINIMUM of the channel bounds (rank-5-broadcastable via a
    length-1 channel axis) — below the row-sum bound, so the step
    condition ``||Sigma^1/2 K T^1/2|| <= 1`` still holds.  Primal steps
    are always separable: per-field lists.  All masks stay broadcastable
    (call inside jit — nothing volume-sized is materialized beyond
    ``|A|^T 1``, which is real data)."""
    dims = {"2d": (2, 3), "3d": (0, 2, 3), "4d": (0, 1, 2, 3)}[axes]
    n = len(dims)
    pairs = [(i, i) for i in range(n)] + [
        (i, j) for i in range(n) for j in range(i + 1, n)
    ]

    def ge1(d):
        return _axis_mask(vol_shape, d, "ge1", dtype)

    def lem2(d):
        return _axis_mask(vol_shape, d, "lem2", dtype)

    # dual of (D x - w): row sum = 2*[fwd slot valid] + 1 (the -I entry)
    sp = [1.0 / (2.0 * lem2(d) + 1.0) for d in dims]
    # dual of E w: diag channel rows sum to 2*[bwd valid]; off-diag (i, j)
    # rows sum to |0.5|*2 per valid part (all-zero rows: the dual stays 0,
    # any finite step is fine)
    sq = []
    for (i, j) in pairs:
        if i == j:
            r = 2.0 * ge1(dims[i])
        else:
            r = ge1(dims[j]) + ge1(dims[i])
        sq.append(1.0 / jnp.where(r == 0, 1.0, r))
    if norm == "aniso":
        sig_p, sig_q = sp, sq
    else:
        sig_p = functools.reduce(jnp.minimum, sp)[:, None]
        sig_q = functools.reduce(jnp.minimum, sq)[:, None]

    # primal x: |A|^T 1 + per-axis fwd-diff column sums
    tx_den = sum(lem2(d) + ge1(d) for d in dims)
    if A is not None:
        tx_den = tx_den + A_T(jnp.ones(b_shape, dtype))
    T_x = 1.0 / jnp.where(tx_den == 0, 1.0, tx_den)
    # primal w_i: 1 (the -I) + bwd column sums from every E channel —
    # separable, so per-field exactness holds for every norm
    T_w = []
    for i in range(n):
        den = 1.0 + ge1(dims[i]) + lem2(dims[i])
        for j in range(n):
            if j != i:
                den = den + 0.5 * (ge1(dims[j]) + lem2(dims[j]))
        T_w.append(1.0 / den)

    sig_A = None
    if A is not None:
        from .inverse import fidelity_row_precond

        sig_A = fidelity_row_precond(A, b_shape, vol_shape, dtype)
    return sig_A, sig_p, sig_q, T_x, T_w


def _chanmul(maps, arr):
    """Multiply a channel-stacked rank-5 array by per-channel rank-4
    broadcastable maps (or by one rank-5-broadcastable map)."""
    if isinstance(maps, (list, tuple)):
        return jnp.stack([maps[i] * arr[:, i] for i in range(len(maps))],
                         axis=1)
    return maps * arr


def tgv_gap_inverse(
    state: TGVInverseState,
    A,
    b,
    alpha1: float = 1.0,
    alpha0: float = 2.0,
    axes: str = "2d",
    norm: str = "iso",
    huber_delta: float = 1.0,
    fidelity: str = "l2",
    fidelity_weight=1.0,
    x_box: float = None,
    w_box: float = None,
    A_T=None,
):
    """Certified duality gap for the TGV-2 inverse problem

        min_{(x, w) in C} F(A x) + a1 N(D x - w) + a0 N(E w)

    at ``(state.x, state.w, state.y_A, state.p, state.q)`` — the TGV
    counterpart of :func:`..inverse.pd_gap_inverse` over the two primal
    blocks of K = [[A, 0], [D, -I], [0, E]]:

        gap = P(x, w) + F*(y_A) + N1*(p) + N0*(q)
            + sup_{x in Cx} <-r_x, x> + sup_{w in Cw} <-r_w, w>,
        r_x = A^T y_A + D^T p,   r_w = -p + E^T q,

    with the duals projected feasible first (a1/a0 balls or boxes; Huber
    conjugates gain the quadratic).  The prior sets: ``x_box = c`` is the
    physical bound ``0 <= x <= c``; ``w_box`` bounds the auxiliary field
    componentwise, ``|w| <= w_box`` (w tracks the gradient of x, so the
    gradient bound of a ``[0, c]`` image — ``w_box = c``, the default — is
    the natural prior; the certificate is a bound on
    ``P - min_C P`` whenever the true minimizer satisfies both).  Both
    support terms vanish as the dual residuals converge.  Composes with
    ``run_until_converged(criterion='gap', gap_x_box=..., gap_w_box=...)``.
    """
    from .fidelity import fidelity_conjugate, fidelity_loss

    if x_box is None:
        raise ValueError(
            "tgv_gap_inverse needs the compact prior set: pass x_box=c "
            "(0 <= x <= c; w_box defaults to c — the gradient bound of a "
            "[0, c] image)"
        )
    if w_box is None:
        w_box = x_box
    vol_shape = tuple(state.x.shape)
    dtype = state.x.dtype
    d_fwd, sym_grad, d_T, sym_T, n_w, n_q, _ = _tgv_ops(axes, vol_shape,
                                                        dtype)
    x, w, y_A, p, q = state.x, state.w, state.y_A, state.p, state.q
    primal = fidelity_loss(A(x), b, fidelity, fidelity_weight) + (
        alpha1 * _tgv_norm_val(d_fwd(x) - w, norm, huber_delta)
        + alpha0 * _tgv_norm_val(sym_grad(w), norm, huber_delta)
    )
    y_A, f_star = fidelity_conjugate(y_A, b, fidelity, fidelity_weight)
    p = _tgv_dual_prox(p, alpha1, norm, 0.0, huber_delta)
    q = _tgv_dual_prox(q, alpha0, norm, 0.0, huber_delta)
    tv_star = 0.0
    if norm == "huber":
        tv_star = (huber_delta / (2.0 * alpha1) * jnp.sum(jnp.square(p))
                   + huber_delta / (2.0 * alpha0) * jnp.sum(jnp.square(q)))
    if A_T is None:
        from .inverse import cached_transpose

        A_T = cached_transpose(A, vol_shape, jnp.dtype(dtype).name)
    r_x = A_T(y_A) + d_T(p)
    r_w = -p + sym_T(q)
    sup_x = x_box * jnp.sum(jnp.maximum(-r_x, 0.0))
    sup_w = w_box * jnp.sum(jnp.abs(r_w))   # sign-free box on w
    return primal + f_star + tv_star + sup_x + sup_w


def tgv_inverse(
    A,
    b,
    vol_shape,
    A_T=None,
    n_iter: int = 100,
    alpha1: float = 1.0,
    alpha0: float = 2.0,
    axes: str = "2d",
    op_norm: float = None,
    x_init=None,
    precond: bool = False,
    norm: str = "iso",
    huber_delta: float = 1.0,
    fidelity: str = "l2",
    fidelity_weight=1.0,
    nonneg: bool = False,
    state: TGVInverseState = None,
) -> TGVResult:
    """TGV-2-regularized linear inverse problem:

        min_{x, w} F(A x) + a1 ||D x - w||_{2,1} + a0 ||E w||_{2,1}

    for ANY jax-traceable linear forward operator ``A`` (CT projection,
    blur, inpainting masks, ...) — the TGV counterpart of
    ``solvers.cp_inverse``, removing first-order TV's staircasing from
    reconstructions of piecewise-linear objects (classic TGV-CT: Bredies,
    Kunisch & Pock 2010).  Chambolle-Pock over K = [[A, 0], [D, -I],
    [0, E]]; ``A_T`` defaults to the exact transpose via
    ``jax.linear_transpose``; step rule
    ``sigma = tau = 1/sqrt(||A||^2 + ||K_tgv||^2)`` with the per-axes-mode
    TGV block bound of ``tgv_denoise``.  ``models.ct.tgv_reconstruct`` is
    this solver specialized to the CT projectors.

    ``precond=True`` switches to the diagonally-preconditioned iteration
    (Pock & Chambolle 2011, alpha=1): per-element step sizes from the EXACT
    row/column absolute sums of K (closed-form boundary masks for D/E; the
    projector's own row/column sums for A — exact whenever A has
    nonnegative coefficients, as the CT projectors, blurs and masks here
    do).  No ``op_norm``/power iteration needed, and TGV-CT converges in
    roughly half the iterations (tested).

    ``fidelity`` selects the data term ``F`` (``solvers.fidelity``):
    ``'l2'`` = ``weight/2 ||Ax - b||^2`` (default), ``'l1'`` (impulsive
    noise), ``'kl'`` (Poisson counts, ``b >= 0``); ``fidelity_weight`` a
    scalar or per-measurement array.  ``nonneg=True`` projects the primal
    onto ``x >= 0``.  ``state`` resumes from ``result.state`` (bit-exact
    continuation; composes with ``solvers.state`` checkpointing and
    ``run_until_converged`` via ``functools.partial``)."""
    from .fidelity import fidelity_dual_prox, fidelity_loss, validate_fidelity
    from .inverse import exact_transpose, power_iteration

    b = jnp.asarray(b)
    dtype = b.dtype
    validate_fidelity(fidelity, b, fidelity_weight)
    vol_shape = tuple(vol_shape)
    if len(vol_shape) != 4:
        raise ValueError(
            f"tgv_inverse expects a rank-4 (Nz, M, N_row, N_col) vol_shape, "
            f"got {vol_shape}"
        )
    if norm not in ("iso", "aniso", "huber"):
        raise ValueError(f"norm must be 'iso', 'aniso' or 'huber', got "
                         f"{norm!r}")
    if A_T is None:
        from .inverse import cached_transpose

        A_T = cached_transpose(A, vol_shape, jnp.dtype(dtype).name)
    d_fwd, sym_grad, d_T, sym_T, n_w, n_q, L_sq = _tgv_ops(
        axes, vol_shape, dtype)
    if precond:
        if op_norm is not None:
            raise ValueError(
                "op_norm and precond=True are mutually exclusive — the "
                "preconditioned steps come from the operator's exact "
                "row/column sums, not an operator-norm bound"
            )
        from .inverse import check_nonneg_operator

        check_nonneg_operator(A, vol_shape, dtype, what="tgv_inverse")
    else:
        if op_norm is None:
            op_norm = float(power_iteration(A, A_T, vol_shape, dtype=dtype))
        sigma = tau = float(1.0 / jnp.sqrt(op_norm ** 2 + L_sq))
    x0 = (jnp.zeros(vol_shape, dtype) if x_init is None
          else jnp.asarray(x_init, dtype))

    fresh = state is None
    run = _make_tgv_inverse_run(
        A, A_T, vol_shape, axes, bool(precond), norm, float(huber_delta),
        fidelity, bool(nonneg), int(n_iter), jnp.dtype(dtype).name, fresh,
    )
    steps = (0.0, 0.0) if precond else (sigma, tau)
    init = x0 if fresh else TGVInverseState(*state)

    def _scalar(a):  # stays traced under the caller's jax.grad/jit
        return a if isinstance(a, jax.core.Tracer) else float(a)

    from .inverse import _operator_proto

    op_consts = A.prepare() if _operator_proto(A) else ()
    final, losses = run(b, init, jnp.asarray(fidelity_weight, dtype),
                        _scalar(alpha1), _scalar(alpha0), *steps,
                        op_consts)
    final = TGVInverseState(*final)
    return TGVResult(x=final.x, w=final.w, loss=losses, state=final)


@functools.lru_cache(maxsize=32)
def _make_tgv_inverse_run(A, A_T, vol_shape, axes, precond, norm,
                          huber_delta, fidelity, nonneg, n_iter, dtype_name,
                          fresh):
    """One jitted TGV-CP executable per (operator, config): alpha1/alpha0,
    the step scalars and the fidelity weight are TRACED arguments, so
    regularization sweeps and chunked resumes (``run_until_converged``)
    reuse the same compiled program.  ``fresh=True`` takes just the
    initial volume and allocates the zero state INSIDE jit."""
    from .fidelity import fidelity_dual_prox, fidelity_loss
    from .inverse import _bind_operator, _operator_proto

    dtype = jnp.dtype(dtype_name)
    d_fwd, sym_grad, d_T, sym_T, n_w, n_q, _ = _tgv_ops(
        axes, vol_shape, dtype)
    Nz, M, Nr, Nc = vol_shape
    proto = _operator_proto(A)

    @jax.jit
    def run(b, init, fw, a1, a0, sigma, tau, op_consts):
        A_, A_T_ = _bind_operator(A, A_T, proto, op_consts, vol_shape,
                                  dtype)
        # preconditioner masks are built INSIDE jit so they broadcast
        # lazily — nothing volume-sized is baked into the executable
        if precond:
            sig_A, sig_p, sig_q, T_x, T_w = _tgv_precond_maps(
                vol_shape, axes, dtype, norm=norm, A=A_, A_T=A_T_,
                b_shape=tuple(b.shape))
        else:
            sig_A = sig_p = sig_q = jnp.asarray(sigma, dtype)
            T_x = T_w = jnp.asarray(tau, dtype)
        if fresh:
            # zero duals/fields allocated INSIDE jit: no transient second
            # state-sized buffer in device memory for large fresh runs
            x0 = init
            s0 = A_(x0)
            w0 = jnp.zeros((Nz, n_w, M, Nr, Nc), dtype)
            st0 = (x0, x0, w0, w0, jnp.zeros_like(b),
                   jnp.zeros_like(w0),
                   jnp.zeros((Nz, n_q, M, Nr, Nc), dtype), s0, s0)
        else:
            x, xb, w, wb, y_A, p, q = tuple(init)[:7]
            s_x = init.s_x if init.s_x is not None else A_(x)
            s_xb = init.s_xb if init.s_xb is not None else A_(xb)
            st0 = (x, xb, w, wb, y_A, p, q, s_x, s_xb)

        def step(carry, _):
            # linearity rewrite (solvers.inverse): A(xb) = 2 A(x_new) -
            # A(x) from carried sinogram images — one forward + one
            # adjoint per iteration, the loss reuses the same A(x_new)
            x, xb, w, wb, y_A, p, q, sAx, sAxb = carry
            y_A = fidelity_dual_prox(y_A, sAxb, b, sig_A, fidelity, fw)
            p = _tgv_dual_prox(p + _chanmul(sig_p, d_fwd(xb) - wb), a1,
                               norm, sig_p, huber_delta)
            q = _tgv_dual_prox(q + _chanmul(sig_q, sym_grad(wb)), a0,
                               norm, sig_q, huber_delta)
            x_new = x - T_x * (A_T_(y_A) + d_T(p))
            if nonneg:
                x_new = jnp.maximum(x_new, 0.0)
            w_new = w - _chanmul(T_w, -p + sym_T(q))
            xb = 2.0 * x_new - x
            wb = 2.0 * w_new - w
            s_new = A_(x_new)
            loss = (fidelity_loss(s_new, b, fidelity, fw)
                    + a1 * _tgv_norm_val(d_fwd(x_new) - w_new, norm,
                                         huber_delta)
                    + a0 * _tgv_norm_val(sym_grad(w_new), norm,
                                         huber_delta))
            return (x_new, xb, w_new, wb, y_A, p, q, s_new,
                    2.0 * s_new - sAx), loss

        final, losses = jax.lax.scan(step, st0, length=n_iter)
        return final, losses

    return run
