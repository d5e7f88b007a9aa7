"""Chambolle-Pock primal-dual TV denoising — the reference's user-loop recipe
(``README.md:139-158``, Chambolle & Pock 2011 doi:10.1007/s10851-010-0251-1)
promoted to a jit-compiled, device-resident ``lax.scan`` solver.

Minimizes ``1/2 ||x - x0||^2 + reg * TV(x)``.  The dual TV prox uses
``keepdims=True`` so it is correct for all of 2D/3D/4D — the README's own
prox line broadcasts correctly only in the 2D case (SURVEY.md section 2.4.6).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.config import TVConfig
from ..core.schemes import num_channels, operator_norm_bound_sq
from ..ops.operators import D, D_T, compute_L21_norm, tv_norm


class CPState(NamedTuple):
    x: jax.Array     # primal iterate (Nz, M, N_row, N_col)
    y_A: jax.Array   # dual variable of the fidelity term, same shape as x
    y_D: jax.Array   # dual variable of the TV term (Nz, Nd, M, N_row, N_col)


class CPPrecondState(NamedTuple):
    """Carry of :func:`chambolle_pock_precond` — the over-relaxed iterate
    rides along so resume is bit-exact."""
    x: jax.Array
    x_bar: jax.Array
    y_A: jax.Array
    y_D: jax.Array


class CPResult(NamedTuple):
    x: jax.Array
    state: CPState
    loss: jax.Array  # per-iteration loss history (n_iter,)


def default_tau(cfg: TVConfig, Nz: int, M: int, sigma_A: float = 1.0) -> float:
    """Reference step rule ``tau = 1/(||D||^2 + sigma_A)`` — the README's
    ``1/(8+1)`` with 8 = hybrid-scheme bound (``README.md:141-143``),
    generalized per scheme/config via the stencil table."""
    L2 = operator_norm_bound_sq(cfg.scheme, Nz, M, cfg.reg_z_over_reg, cfg.reg_time)
    return 1.0 / (L2 + sigma_A)


def _require_scalar_weight(fidelity_weight, what: str):
    """The denoising solvers jit with ``fidelity_weight`` static — an array
    weight would die with an opaque unhashable-type jit error, so fail with
    guidance first."""
    import numpy as np

    if isinstance(fidelity_weight, (int, float)):
        return float(fidelity_weight)
    if np.ndim(fidelity_weight) == 0 and not isinstance(
        fidelity_weight, jax.core.Tracer
    ):
        return float(fidelity_weight)
    raise ValueError(
        f"{what} takes a SCALAR fidelity_weight (it is static under jit); "
        f"for a per-measurement weight array use the inverse solvers, e.g. "
        f"cp_inverse(A=lambda x: x, fidelity_weight=w)"
    )


def dual_prox(p, reg, norm: str, sigma=1.0, huber_delta: float = 1.0):
    """Prox of the TV term's convex conjugate: the per-pixel L2 reg-ball
    projection for isotropic TV (``README.md:150-151``), the [-reg, reg] box
    for anisotropic L1,1, and for Huber-TV a shrink by ``1 + sigma*delta/reg``
    before the ball projection (F* gains the quadratic
    ``delta/(2 reg) |y|^2``, Chambolle & Pock 2011 section 6.2; ``sigma``
    may be a per-slot map for the preconditioned solver)."""
    from ..ops.operators import _safe_sqrt

    if norm == "aniso":
        return jnp.clip(p, -reg, reg)
    if norm == "huber":
        p = p / (1.0 + sigma * huber_delta / reg)
    # safe sqrt: bit-identical primal, finite reverse-mode gradient at the
    # p = 0 pixels every cold-started solve passes through
    p_norms = _safe_sqrt(jnp.sum(jnp.square(p), axis=1, keepdims=True), jnp)
    return p / jnp.maximum(1.0, p_norms / reg)


def store_dual(y_D, dual_dtype):
    """``y_D`` rounded to its storage dtype ``dual_dtype`` (None: as is).
    XLA drops a narrowing convert that is widened again (excess precision
    is allowed), which left an f32 copy of the Nd-channel dual beside the
    bf16 one; the barrier keeps the rounded dual as the only copy, which
    the primal update then reads."""
    if dual_dtype is None or jnp.dtype(dual_dtype) == y_D.dtype:
        return y_D
    return jax.lax.optimization_barrier(y_D.astype(dual_dtype))


def cp_step(state: CPState, x_noisy, *, reg, sigma_D, sigma_A, tau, cfg: TVConfig,
            mask_static=None, weight_time=None, fidelity="l2",
            fidelity_weight=1.0, nonneg=False, dual_dtype=None):
    """One CP iteration, exactly the reference recipe (``README.md:146-157``):

    - fidelity dual:  y_A <- (y_A + sigma_A (x - x0)) / (1 + sigma_A)
      (with ``fidelity='l1'``/``'kl'``: the matching conjugate prox,
      ``solvers.fidelity`` — TV-L1 / Poisson denoising)
    - TV dual prox:   y_D <- p / max(1, |p|_2 / reg),  p = y_D + sigma_D D x
    - primal:         x   <- x - tau y_A - tau D^T y_D  (then the x >= 0
      projection when ``nonneg``)
    - loss:           F(x_new) + reg * L21(D x_old)
      (the reference reuses the pre-update ``D_x`` in the loss line)

    ``dual_dtype`` rounds the new y_D to its storage dtype before the
    primal update reads it, so a low-precision dual is written once, in
    that dtype; y_D may come in stored in it and is widened where used.
    """
    from .fidelity import fidelity_dual_prox, fidelity_loss

    kw = dict(mask_static=mask_static, weight_time=weight_time,
              **cfg.kwargs())
    x, y_A, y_D = state
    y_A = fidelity_dual_prox(y_A, x, x_noisy, sigma_A, fidelity,
                             fidelity_weight)
    D_x = D(x, cfg.scheme, **kw)
    p = y_D.astype(D_x.dtype) + sigma_D * D_x
    y_D = store_dual(dual_prox(p, reg, cfg.norm, sigma_D, cfg.huber_delta),
                     dual_dtype)
    x = x - tau * y_A - tau * D_T(y_D.astype(x.dtype), cfg.scheme, **kw)
    if nonneg:
        x = jnp.maximum(x, 0.0)
    loss = fidelity_loss(x, x_noisy, fidelity, fidelity_weight) + reg * tv_norm(
        D_x, cfg.norm, huber_delta=cfg.huber_delta)
    return CPState(x, y_A, y_D), loss


def cp_step_precond(state_and_bar, x_noisy, *, reg, sigma_D_map, tau_map,
                    sigma_A, cfg: TVConfig, fidelity="l2",
                    fidelity_weight=1.0, nonneg=False):
    """One diagonally-preconditioned CP iteration (Pock & Chambolle 2011)
    with over-relaxation: per-slot dual steps, per-pixel primal steps —
    no operator-norm tuning needed, and faster on anisotropic configs
    (reg_z/reg_time far from 1)."""
    from .fidelity import fidelity_dual_prox, fidelity_loss

    kw = cfg.kwargs()
    x, x_bar, y_A, y_D = state_and_bar
    y_A = fidelity_dual_prox(y_A, x_bar, x_noisy, sigma_A, fidelity,
                             fidelity_weight)
    D_x = D(x_bar, cfg.scheme, **kw)
    p = y_D + sigma_D_map * D_x
    y_D = dual_prox(p, reg, cfg.norm, sigma_D_map, cfg.huber_delta)
    x_new = x - tau_map * (y_A + D_T(y_D, cfg.scheme, **kw))
    if nonneg:
        x_new = jnp.maximum(x_new, 0.0)
    x_bar = 2.0 * x_new - x
    loss = fidelity_loss(x_new, x_noisy, fidelity, fidelity_weight) + (
        reg * tv_norm(D(x_new, cfg.scheme, **kw), cfg.norm,
                      huber_delta=cfg.huber_delta)
    )
    return (x_new, x_bar, y_A, y_D), loss


def chambolle_pock_precond(
    x_noisy,
    n_iter: int = 300,
    reg: float = 25.0,
    sigma_A: float = 1.0,
    cfg: TVConfig = TVConfig(),
    state=None,
    fidelity: str = "l2",
    fidelity_weight: float = 1.0,
    nonneg: bool = False,
) -> CPResult:
    """Diagonally-preconditioned Chambolle-Pock: parameter-free step sizes
    from the stencil table (``ops.operators.precond_maps``).  Carries the
    fidelity family of :func:`chambolle_pock`.  ``state`` resumes from
    ``result.state`` (a :class:`CPPrecondState` — the over-relaxed iterate
    must ride along for bit-exact continuation)."""
    from .fidelity import validate_fidelity

    fidelity_weight = _require_scalar_weight(
        fidelity_weight, "chambolle_pock_precond")
    validate_fidelity(fidelity, x_noisy, fidelity_weight)
    return _chambolle_pock_precond_jit(
        x_noisy, n_iter=n_iter, reg=reg, sigma_A=sigma_A, cfg=cfg,
        state=state, fidelity=fidelity, fidelity_weight=fidelity_weight,
        nonneg=nonneg,
    )


@functools.partial(
    jax.jit, static_argnames=("n_iter", "cfg", "reg", "sigma_A", "fidelity",
                              "fidelity_weight", "nonneg")
)
def _chambolle_pock_precond_jit(
    x_noisy,
    n_iter: int = 300,
    reg: float = 25.0,
    sigma_A: float = 1.0,
    cfg: TVConfig = TVConfig(),
    state=None,
    fidelity: str = "l2",
    fidelity_weight: float = 1.0,
    nonneg: bool = False,
) -> CPResult:
    from ..ops.operators import precond_maps

    # the fidelity rows use the CALLER's sigma_A, so the tau map must be
    # sized against it (Pock-Chambolle: tau_j = 1/(colsum_D_j + sigma_A))
    sigma_D_map, tau_map = precond_maps(
        x_noisy.shape, cfg.scheme, cfg.reg_z_over_reg, cfg.reg_time,
        sigma_A_rows=sigma_A,
    )
    sigma_D_map = sigma_D_map.astype(x_noisy.dtype)
    tau_map = tau_map.astype(x_noisy.dtype)
    if state is None:
        st = init_state(x_noisy, cfg)
        carry0 = (st.x, st.x, st.y_A, st.y_D)
    else:
        carry0 = tuple(CPPrecondState(*state))

    def body(carry, _):
        carry, loss = cp_step_precond(
            carry, x_noisy, reg=reg, sigma_D_map=sigma_D_map,
            tau_map=tau_map, sigma_A=sigma_A, cfg=cfg, fidelity=fidelity,
            fidelity_weight=fidelity_weight, nonneg=nonneg,
        )
        return carry, loss

    (x, x_bar, y_A, y_D), losses = jax.lax.scan(body, carry0, length=n_iter)
    return CPResult(x=x, state=CPPrecondState(x, x_bar, y_A, y_D),
                    loss=losses)


@functools.partial(jax.jit, static_argnames=("reg", "cfg"))
def pd_gap(state: CPState, x_noisy, reg: float = 25.0,
           cfg: TVConfig = TVConfig(), mask_static=None, weight_time=None):
    """Duality gap of the TV denoising problem at ``(state.x, state.y_D)``
    — a certified distance to optimality, unlike loss-delta heuristics:

        gap = P(x) - g(y) >= P(x) - P(x*) >= 0

    with ``P(x) = 1/2 ||x - x0||^2 + reg ||Dx||`` and the dual
    ``g(y) = <D^T y, x0> - 1/2 ||D^T y||^2 - F*(y)`` (for Huber-TV,
    ``F*(y) = delta/(2 reg) ||y||^2`` on the ball; 0 for iso/aniso).
    ``y`` is projected onto the dual ball first — a no-op for CP iterates
    (the prox keeps them feasible) that makes the bound valid for ANY
    input.  l2 fidelity only (the reference denoising model)."""
    kw = dict(mask_static=mask_static, weight_time=weight_time,
              **cfg.kwargs())
    x, y_D = state.x, state.y_D
    # feasibility projection = the sigma->0 dual prox (pure ball/box)
    y = dual_prox(y_D, reg, cfg.norm, 0.0, cfg.huber_delta)
    primal = 0.5 * jnp.sum(jnp.square(x - x_noisy)) + reg * tv_norm(
        D(x, cfg.scheme, **kw), cfg.norm, huber_delta=cfg.huber_delta)
    dty = D_T(y, cfg.scheme, **kw)
    dual = jnp.sum(dty * x_noisy) - 0.5 * jnp.sum(jnp.square(dty))
    if cfg.norm == "huber":
        dual = dual - cfg.huber_delta / (2.0 * reg) * jnp.sum(jnp.square(y))
    return primal - dual


def init_state(x_noisy, cfg: TVConfig, x_init=None,
               dual_dtype=None) -> CPState:
    """A cold CP state; y_D is allocated directly in ``dual_dtype``
    (default: the input's dtype), so a low-precision dual never exists at
    full precision."""
    Nz, M = x_noisy.shape[0], x_noisy.shape[1]
    Nd = num_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg, cfg.reg_time)
    x = x_noisy if x_init is None else x_init
    y_A = jnp.zeros_like(x_noisy)
    y_D = jnp.zeros((Nz, Nd, M) + x_noisy.shape[2:],
                    dtype=dual_dtype or x_noisy.dtype)
    return CPState(x=x, y_A=y_A, y_D=y_D)


def chambolle_pock(
    x_noisy,
    n_iter: int = 300,
    reg: float = 25.0,
    sigma_D: float = 0.5,
    sigma_A: float = 1.0,
    tau: float = None,
    cfg: TVConfig = TVConfig(),
    state: CPState = None,
    mask_static=None,
    weight_time=None,
    dual_dtype: str = None,
    return_dual: bool = True,
    progress_every: int = 0,
    progress_fn=None,
    fidelity: str = "l2",
    fidelity_weight: float = 1.0,
    nonneg: bool = False,
) -> CPResult:
    """Eager front door of :func:`_chambolle_pock_jit` (which holds the
    full docstring): argument validation must run OUTSIDE the jit boundary
    so data-dependent checks (``fidelity='kl'`` needs ``x_noisy >= 0``)
    can actually fire on concrete inputs."""
    from .fidelity import validate_fidelity

    fidelity_weight = _require_scalar_weight(fidelity_weight, "chambolle_pock")
    validate_fidelity(fidelity, x_noisy, fidelity_weight)
    return _chambolle_pock_jit(
        x_noisy, n_iter=n_iter, reg=reg, sigma_D=sigma_D, sigma_A=sigma_A,
        tau=tau, cfg=cfg, state=state, mask_static=mask_static,
        weight_time=weight_time, dual_dtype=dual_dtype,
        return_dual=return_dual, progress_every=progress_every,
        progress_fn=progress_fn, fidelity=fidelity,
        fidelity_weight=fidelity_weight, nonneg=nonneg,
    )



@functools.partial(
    jax.jit,
    static_argnames=("n_iter", "cfg", "reg", "sigma_D", "sigma_A", "tau",
                     "dual_dtype", "return_dual", "progress_every",
                     "progress_fn", "fidelity", "fidelity_weight", "nonneg"),
)
def _chambolle_pock_jit(
    x_noisy,
    n_iter: int = 300,
    reg: float = 25.0,
    sigma_D: float = 0.5,
    sigma_A: float = 1.0,
    tau: float = None,
    cfg: TVConfig = TVConfig(),
    state: CPState = None,
    mask_static=None,
    weight_time=None,
    dual_dtype: str = None,
    return_dual: bool = True,
    progress_every: int = 0,
    progress_fn=None,
    fidelity: str = "l2",
    fidelity_weight: float = 1.0,
    nonneg: bool = False,
) -> CPResult:
    """Run ``n_iter`` Chambolle-Pock iterations on device.

    Defaults are the reference recipe (``README.md:141-143``): sigma_D=0.5,
    sigma_A=1.0, tau=1/(||D||^2 + sigma_A).  Pass ``state`` (e.g. from a
    checkpoint, see ``solvers.state``) to resume a run.

    Storage and compute precision: x and y_A are carried between
    iterations in the input's dtype and the TV dual y_D in ``dual_dtype``
    (default: the input's dtype); every iteration computes in at least
    float32.  ``dual_dtype='bfloat16'`` halves the largest state (y_D has
    Nd channels, and the primal update reads it as rounded to bf16), and a
    bfloat16 ``x_noisy`` halves the rest, at a small precision cost.  On
    the H100 the bf16 dual is also faster than f32 (PERF.md).
    ``return_dual=False`` drops y_D from the result (state.y_D is None) —
    needed when the volume is so large that converting the dual back to the
    input's dtype would not fit device memory.
    ``progress_every=k`` invokes ``progress_fn(iteration, loss)`` on the
    host every k iterations from inside the scan (``solvers.progress``;
    zero cost when 0; ``progress_fn`` must be hashable).
    ``fidelity`` selects the data term (``solvers.fidelity``): ``'l2'`` =
    ``weight/2 ||x - x0||^2`` (default, the reference recipe), ``'l1'`` =
    TV-L1 denoising (impulsive noise), ``'kl'`` = Poisson denoising
    (requires ``x_noisy >= 0``); ``fidelity_weight`` must be a SCALAR here
    (static — per-pixel weight arrays are the inverse solvers' job:
    ``cp_inverse(A=identity)``); ``nonneg=True`` projects onto x >= 0.
    """
    from .progress import emit_progress

    if tau is None:
        tau = default_tau(cfg, x_noisy.shape[0], x_noisy.shape[1], sigma_A)
    store_dtype = x_noisy.dtype
    dual_store = jnp.dtype(dual_dtype) if dual_dtype else None
    if state is None:
        state = init_state(x_noisy, cfg, dual_dtype=dual_store)
        out_dual_dtype = store_dtype
    else:
        out_dual_dtype = state.y_D.dtype
    if dual_store is None:
        dual_store = state.y_D.dtype
    state = CPState(state.x.astype(store_dtype), state.y_A.astype(store_dtype),
                    state.y_D.astype(dual_store))
    compute = jnp.promote_types(store_dtype, jnp.float32)
    x0 = x_noisy.astype(compute)

    def body(st, i):
        st, loss = cp_step(
            CPState(st.x.astype(compute), st.y_A.astype(compute), st.y_D),
            x0, reg=reg, sigma_D=sigma_D, sigma_A=sigma_A, tau=tau, cfg=cfg,
            mask_static=mask_static, weight_time=weight_time,
            fidelity=fidelity, fidelity_weight=fidelity_weight,
            nonneg=nonneg, dual_dtype=dual_store,
        )
        emit_progress(i, loss, progress_every, progress_fn)
        return CPState(st.x.astype(store_dtype), st.y_A.astype(store_dtype),
                       st.y_D), loss

    final, losses = jax.lax.scan(body, state, jnp.arange(n_iter))
    y_D = final.y_D.astype(out_dual_dtype) if return_dual else None
    final = CPState(final.x, final.y_A, y_D)
    return CPResult(x=final.x, state=final, loss=losses)


# AOT handles for utils.warm_compile (the eager wrappers cannot .lower())
chambolle_pock._jit = _chambolle_pock_jit
chambolle_pock_precond._jit = _chambolle_pock_precond_jit
