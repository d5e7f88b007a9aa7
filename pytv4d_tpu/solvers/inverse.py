"""Generic TV-regularized linear inverse problems:
``min_x 1/2 ||A x - b||^2 + reg * TV(x)`` for ANY jax-traceable linear
forward operator A (CT projection, blur, masking/inpainting, MRI-style
undersampling, ...).

Chambolle-Pock over the joint operator ``K = [A; D]`` with over-relaxation;
``A_T`` defaults to the exact transpose via ``jax.linear_transpose`` so the
adjointness contract holds automatically.  ``models.ct.cp_reconstruct`` is
this solver specialized to the Radon projector.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import TVConfig
from ..core.schemes import num_channels, operator_norm_bound_sq
from ..ops.operators import D, D_T, tv_norm


class InverseState(NamedTuple):
    """Full CP carry of :func:`cp_inverse` for resume/checkpointing
    (``solvers.state.save_state`` / ``run_until_converged``): primal,
    over-relaxed primal, fidelity dual, TV dual.

    ``s_x``/``s_x_bar`` carry the forward projections ``A(x)``/``A(x_bar)``
    of the iterates: the solver derives the over-relaxed projection by
    linearity (``A(2 x_new - x) = 2 A(x_new) - A(x)``), saving one
    projector application per iteration, and carrying these images is what
    keeps RESUME bit-exact (recomputing ``A(x_bar)`` on resume would
    differ from the derived value in the last ulps).  ``None`` (e.g. an
    old checkpoint or a hand-built state) is accepted — the solver then
    recomputes them once, which is exact in math but may differ from an
    uninterrupted run at fp round-off."""
    x: jax.Array
    x_bar: jax.Array
    y_A: jax.Array
    y_D: jax.Array
    s_x: Optional[jax.Array] = None
    s_x_bar: Optional[jax.Array] = None


class InverseResult(NamedTuple):
    x: jax.Array
    loss: jax.Array
    state: InverseState = None


def check_nonneg_operator(A: Callable, vol_shape, dtype, what: str):
    """Eager gate for ``precond=True``: the exact-row/col-sum
    preconditioners assume ``|A| 1 = A 1``, i.e. nonnegative operator
    coefficients (CT projectors, blurs, masks).  ``A(1)`` with negative
    entries proves signed coefficients (the converse does not hold — this
    is a necessary check, documented as such); signed operators (Fourier,
    wavelets, high-pass) must use the operator-norm step rule instead."""
    row = A(jnp.ones(tuple(vol_shape), dtype))
    lo = float(jnp.min(row))
    scale = max(1.0, float(jnp.max(jnp.abs(row))))
    if lo < -1e-6 * scale:
        raise ValueError(
            f"{what}(precond=True) requires a forward operator with "
            f"nonnegative coefficients (A(ones) has negative entries, so "
            f"A(1) != |A| 1 and the preconditioned steps would violate the "
            f"step condition) — use precond=False with op_norm instead"
        )


def fidelity_row_precond(A: Callable, b_shape, vol_shape, dtype):
    """Per-measurement dual step ``sigma_A = 1 / (|A| 1)`` for a nonnegative
    operator (Pock-Chambolle 2011 diagonal preconditioning, alpha=1): the
    reciprocal row sums of A.  Zero rows (rays that miss the volume) are
    floored RELATIVE to the live-row scale so their decoupled duals get a
    bounded step without distorting the live rows — an absolute floor would
    cap sigma_A at a fixed value for uniformly small-scaled operators.
    Shared by cp_inverse and tgv_inverse; call inside jit."""
    row = A(jnp.ones(tuple(vol_shape), dtype))
    floor = 1e-6 * jnp.maximum(jnp.max(row), jnp.asarray(1e-30, dtype))
    return 1.0 / jnp.maximum(row, floor)


def _operator_proto(A: Callable):
    """The optional heavy-operator protocol: ``A.prepare() -> consts``
    (a pytree of device arrays built once per solve) and
    ``A.apply(consts, x)`` (the same linear map with the consts threaded
    as TRACED arguments).  Solvers that scan over A use it to hoist
    expensive input-independent precomputation — e.g. the spectral CT
    projector's NUDFT phase tables (~60 M complex exps per application,
    ``models/ct_spectral.py``) — out of the iteration loop, which XLA's
    own loop-invariant code motion declines to do under memory pressure.
    Returns ``A.apply`` or None."""
    prepare = getattr(A, "prepare", None)
    apply_fn = getattr(A, "apply", None)
    return apply_fn if (prepare is not None and apply_fn is not None) \
        else None


def _bind_operator(A, A_T, proto_apply, op_consts, vol_shape, dtype):
    """Inside a jitted solver run: the (A, A_T) pair actually scanned.
    With the protocol, A binds the traced consts and A_T becomes the vjp
    of the BOUND map (built once, before the scan), so the hoisted consts
    serve both directions."""
    if proto_apply is None:
        return A, A_T

    def A_(x):
        return proto_apply(op_consts, x)

    _, vjp = jax.vjp(A_, jnp.zeros(tuple(vol_shape), dtype))

    def A_T_(y):
        (x_bar,) = vjp(y)
        return x_bar

    return A_, A_T_


def exact_transpose(A: Callable, vol_shape, dtype=jnp.float32) -> Callable:
    """The exact adjoint of a linear map via ``jax.linear_transpose`` —
    passes the dot-product test to fp precision by construction."""
    primal = jax.ShapeDtypeStruct(tuple(vol_shape), dtype)
    transpose = jax.linear_transpose(A, primal)

    def A_T(y):
        (x_bar,) = transpose(y)
        return x_bar

    return A_T


@functools.lru_cache(maxsize=64)
def cached_transpose(A, vol_shape, dtype_name):
    """``exact_transpose`` memoized on the operator identity — repeated
    solver calls with the same ``A`` (chunked resumes, reg sweeps) get the
    SAME adjoint function object, so the cached jitted runners
    (``_make_inverse_run`` and the TGV analog) can be reused instead of
    re-traced per call."""
    return exact_transpose(A, vol_shape, jnp.dtype(dtype_name))


def power_iteration(A: Callable, A_T: Callable, vol_shape, n_iter: int = 12,
                    seed: int = 0, dtype=jnp.float32):
    """Power-method estimate of ||A||_2 for step sizing.  Honors the
    heavy-operator protocol (:func:`_operator_proto`) so a spectral CT
    projector's tables are built once, not per scan iteration."""
    x = jnp.asarray(
        np.random.default_rng(seed).standard_normal(vol_shape), dtype
    )
    proto = _operator_proto(A)
    consts = A.prepare() if proto else ()

    @jax.jit
    def run(x, consts):
        A_, A_T_ = _bind_operator(A, A_T, proto, consts, vol_shape,
                                  jnp.dtype(dtype))

        def body(x, _):
            y = A_T_(A_(x))
            n = jnp.sqrt(jnp.sum(jnp.square(y)))
            return y / jnp.maximum(n, 1e-30), n

        _, norms = jax.lax.scan(body, x / jnp.sqrt(jnp.sum(jnp.square(x))),
                                length=n_iter)
        return jnp.sqrt(norms[-1])

    return run(x, consts)


def pd_gap_inverse(
    state: "InverseState",
    A: Callable,
    b,
    reg: float = 1.0,
    cfg: TVConfig = TVConfig(),
    fidelity: str = "l2",
    fidelity_weight=1.0,
    x_box: Optional[float] = None,
    norm_bound: Optional[float] = None,
    A_T: Optional[Callable] = None,
):
    """Certified duality gap for the inverse problem
    ``min_{x in C} F(A x) + reg TV(x)`` at ``(state.x, state.y_A,
    state.y_D)`` — the inverse-solver analog of :func:`..cp.pd_gap`.

    Unlike denoising, the fidelity here composes with ``A``, so Fenchel
    duality leaves a residual ``r = A^T y_A + D^T y_D`` that is only zero
    at the exact dual optimum; a finite certificate needs a compact prior
    set ``C`` containing the minimizer to absorb it (the classical
    bounded-domain device):

        gap(x, y) = F(A x) + reg TV(x)            [primal P(x)]
                  + F*(y_A) + TV*(y_D)            [conjugates, y projected
                                                   feasible first]
                  + sup_{z in C} <-r, z>          [support function of C]
            >= P(x) - min_{z in C} P(z) >= 0.

    ``C`` comes from whichever bound you can assert about the true
    solution (pass at least one; both = the tighter certificate wins):

    - ``x_box = c``: the box ``0 <= x <= c`` (natural for attenuation
      coefficients — c is the maximum physical attenuation);
      ``sup = c * sum(relu(-r))``.
    - ``norm_bound = R``: the ball ``||x||_2 <= R`` (sign-free);
      ``sup = R * ||r||_2``.

    As the iterates converge, ``r -> 0`` and the support term vanishes, so
    the certificate is asymptotically tight.  ``fidelity`` in
    ``('l2', 'l1', 'kl')`` via :func:`..fidelity.fidelity_conjugate`; the
    TV dual is ball/box-projected exactly as in ``pd_gap`` (for Huber-TV
    its conjugate gains the quadratic).  Composes with
    ``run_until_converged(criterion='gap', gap_x_box=...)``.
    """
    from .cp import dual_prox
    from .fidelity import fidelity_conjugate, fidelity_loss

    if x_box is None and norm_bound is None:
        raise ValueError(
            "pd_gap_inverse needs a compact prior set containing the true "
            "solution to certify against — pass x_box=c (the physical "
            "upper bound, 0 <= x <= c) and/or norm_bound=R (||x||_2 <= R)"
        )
    kw = cfg.kwargs()
    x, y_A, y_D = state.x, state.y_A, state.y_D
    primal = fidelity_loss(A(x), b, fidelity, fidelity_weight) + (
        reg * tv_norm(D(x, cfg.scheme, **kw), cfg.norm,
                      huber_delta=cfg.huber_delta)
    )
    # feasibility projections make the bound valid for ANY input
    y_A, f_star = fidelity_conjugate(y_A, b, fidelity, fidelity_weight)
    y = dual_prox(y_D, reg, cfg.norm, 0.0, cfg.huber_delta)
    tv_star = 0.0
    if cfg.norm == "huber":
        tv_star = cfg.huber_delta / (2.0 * reg) * jnp.sum(jnp.square(y))
    if A_T is None:
        A_T = cached_transpose(A, tuple(x.shape), jnp.dtype(x.dtype).name)
    r = A_T(y_A) + D_T(y, cfg.scheme, **kw)
    sup_terms = []
    if x_box is not None:
        sup_terms.append(x_box * jnp.sum(jnp.maximum(-r, 0.0)))
    if norm_bound is not None:
        sup_terms.append(norm_bound * jnp.sqrt(jnp.sum(jnp.square(r))))
    sup_C = sup_terms[0] if len(sup_terms) == 1 else jnp.minimum(*sup_terms)
    return primal + f_star + tv_star + sup_C


def cp_inverse(
    A: Callable,
    b,
    vol_shape,
    A_T: Optional[Callable] = None,
    n_iter: int = 100,
    reg: float = 1.0,
    cfg: TVConfig = TVConfig(),
    op_norm: Optional[float] = None,
    x_init=None,
    precond: bool = False,
    fidelity: str = "l2",
    fidelity_weight=1.0,
    nonneg: bool = False,
    state: Optional[InverseState] = None,
    dual_dtype: str = None,
    loss_every: int = 1,
    precond_sums=None,
    precond_scale: float = 1.0,
) -> InverseResult:
    """Solve ``min_x F(A x) + reg TV(x)`` with Chambolle-Pock.

    ``A`` maps a ``vol_shape`` volume to the data space of ``b``; it must be
    linear and jax-traceable.  Step rule:
    ``tau = sigma = 1/sqrt(||A||^2 + ||D||^2)``.

    ``fidelity`` selects the data term ``F`` (``solvers.fidelity``):
    ``'l2'`` = ``weight/2 ||Ax - b||^2`` (default), ``'l1'`` =
    ``weight ||Ax - b||_1`` (impulsive noise), ``'kl'`` = Poisson
    log-likelihood (photon-count CT; requires ``b >= 0``).
    ``fidelity_weight`` may be a scalar or per-measurement array.
    ``nonneg=True`` constrains ``x >= 0`` (projection prox — standard for
    attenuation coefficients in CT).

    ``precond=True``: diagonally-preconditioned steps (Pock & Chambolle
    2011, alpha=1) from the EXACT row/column absolute sums of ``[A; D]``
    (``ops.operators.precond_maps``; the A sums are exact whenever A has
    nonnegative coefficients — CT projectors, blurs, masks).  No
    ``op_norm``/power iteration, and typically several-fold fewer
    iterations (see the TGV analog in solvers/tgv.py).

    ``precond_sums=(row_sum, col_sum)`` supplies EXTERNAL absolute-sum
    surrogates ``|A| 1`` (data-shaped) / ``|A|^T 1`` (volume-shaped) for
    a SIGNED operator whose plain ``A(1)``/``A^T(1)`` would underestimate
    them (e.g. the spectral cone's abs-factor surrogate,
    ``models.ct_spectral.cone_spectral_precond_sums``) — the
    nonnegative-operator gate is skipped, so the caller owns validity.
    ``precond_scale >= 1`` divides ALL preconditioned steps by the given
    factor: with ``rho = ||Sigma^{1/2} K T^{1/2}||`` measured by a power
    method, ``precond_scale = rho`` restores the step condition
    ``||(Sigma/s)^{1/2} K (T/s)^{1/2}|| <= 1`` when surrogate sums are
    only approximate bounds (``models.ct`` computes it for the cone).

    ``state`` resumes a previous run from ``result.state`` (bit-exact
    continuation — the over-relaxed iterate and both duals are carried);
    composes with ``solvers.state`` checkpointing and
    ``run_until_converged`` (pass the solver as
    ``functools.partial(cp_inverse, A, vol_shape=shape, ...)`` so the
    data ``b`` is the leading argument).

    ``dual_dtype='bfloat16'`` stores the Nd-channel TV dual between
    iterations in bf16 (each iteration still computes in float32, and the
    primal update reads the dual as rounded to bf16) — at CT production
    scale the dual is by far the largest state (e.g. 2.1 GB at
    (16,4,512,512)×8 channels in f32), so this halves its storage.  Its
    effect on time is measured in PERF.md.

    ``loss_every=k`` (a positive divisor of ``n_iter``) samples the loss
    once per k iterations (TGV convention: ``result.loss`` has length
    ``n_iter // k``, each entry the loss at its chunk's last iteration).
    The forward projection ``A(x_new)`` is always paid — the carry needs
    it for the linearity rewrite ``A(x_bar) = 2 A(x_new) - A(x)`` — so
    skipping the loss only skips the TV-norm evaluation and fidelity sum
    on k - 1 of every k iterations.
    """
    from .fidelity import validate_fidelity

    b = jnp.asarray(b)
    dtype = b.dtype
    validate_fidelity(fidelity, b, fidelity_weight)
    if loss_every < 1 or n_iter % loss_every:
        raise ValueError(
            f"loss_every must be a positive divisor of n_iter, got "
            f"loss_every={loss_every} with n_iter={n_iter}"
        )
    if A_T is None:
        A_T = cached_transpose(A, tuple(vol_shape), jnp.dtype(dtype).name)
    if precond:
        if op_norm is not None:
            raise ValueError(
                "op_norm and precond=True are mutually exclusive — the "
                "preconditioned steps come from the operator's exact "
                "row/column sums, not an operator-norm bound"
            )
        if precond_sums is None:
            check_nonneg_operator(A, vol_shape, dtype, what="cp_inverse")
        sigma = tau = sigma_A = None  # built inside the jitted run
    else:
        if op_norm is None:
            op_norm = float(power_iteration(A, A_T, vol_shape, dtype=dtype))
        L_sq = op_norm ** 2 + operator_norm_bound_sq(
            cfg.scheme, vol_shape[0], vol_shape[1], cfg.reg_z_over_reg,
            cfg.reg_time,
        )
        sigma = tau = float(1.0 / np.sqrt(L_sq))
        sigma_A = sigma
    Nd = num_channels(cfg.scheme, vol_shape[0], vol_shape[1],
                      cfg.reg_z_over_reg, cfg.reg_time)
    x0 = jnp.zeros(vol_shape, dtype) if x_init is None else jnp.asarray(
        x_init, dtype)

    reg_traced = isinstance(reg, jax.core.Tracer)
    if precond_sums is not None and not precond:
        raise ValueError("precond_sums requires precond=True")
    if precond_scale != 1.0 and not precond:
        raise ValueError("precond_scale requires precond=True")
    init = x0 if state is None else InverseState(*state)
    fw = jnp.asarray(fidelity_weight, dtype)
    # heavy-operator protocol (_operator_proto): precompute the operator's
    # input-independent constants ONCE per solve and thread them through
    # the jitted run as traced, loop-invariant arguments
    op_consts = A.prepare() if _operator_proto(A) else ()

    run = _make_inverse_run(
        A, A_T, tuple(vol_shape), cfg, bool(precond), fidelity,
        bool(nonneg), int(n_iter), jnp.dtype(dtype).name, Nd,
        fresh=state is None, loss_every=int(loss_every),
        has_sums=precond_sums is not None,
        dual_dtype_name=jnp.dtype(dual_dtype).name if dual_dtype else None,
    )
    steps = ((0.0, 0.0, 0.0) if precond else (sigma, tau, sigma_A))
    # reg stays traced when the caller differentiates through the solve
    # (unrolled hyperparameter gradients, cf. Bertrand et al. 2020)
    reg_t = reg if reg_traced else float(reg)
    psums = () if precond_sums is None else tuple(
        jnp.asarray(s, dtype) for s in precond_sums)
    final, losses = run(b, init, fw, reg_t, *steps, op_consts, psums,
                        jnp.asarray(float(precond_scale), dtype))
    final = InverseState(*final)
    if dual_dtype is not None:
        out_dual = dtype if state is None else state.y_D.dtype
        final = final._replace(y_D=final.y_D.astype(out_dual))
    return InverseResult(x=final.x, loss=losses, state=final)


@functools.lru_cache(maxsize=32)
def _make_inverse_run(A, A_T, vol_shape, cfg, precond, fidelity, nonneg,
                      n_iter, dtype_name, Nd, fresh, loss_every=1,
                      has_sums=False, dual_dtype_name=None):
    """One jitted CP executable per (operator, config) — ``reg``, the step
    scalars and the fidelity weight are TRACED arguments, so a reg sweep
    (``reg_discrepancy``) or changed step sizes reuse the same compiled
    program instead of paying a recompile per value.  ``fresh=True``
    takes just the initial volume and allocates the zero duals INSIDE jit
    (no transient second dual-sized buffer in device memory).
    ``dual_dtype_name`` is y_D's storage dtype between iterations; the TV
    half of each iteration computes in at least float32."""
    from .cp import dual_prox, store_dual
    from .fidelity import fidelity_dual_prox, fidelity_loss

    dtype = jnp.dtype(dtype_name)
    dual_dtype = jnp.dtype(dual_dtype_name or dtype_name)
    compute = jnp.promote_types(dtype, jnp.float32)
    kw = cfg.kwargs()
    proto = _operator_proto(A)

    @jax.jit
    def run(b, init, fw, reg, sigma, tau, sigma_A, op_consts, psums,
            pscale):
        A_, A_T_ = _bind_operator(A, A_T, proto, op_consts, vol_shape,
                                  dtype)
        if precond:
            # maps built inside jit from tiny boundary masks + one |A|^T 1
            # volume — nothing volume-sized is baked into the executable
            from ..ops.operators import precond_maps

            if has_sums:
                # externally supplied |A| surrogate sums (signed
                # operators, e.g. the spectral cone) + the caller's
                # verified step rescale (see cp_inverse docstring)
                row, col = psums
            else:
                col = A_T_(jnp.ones(tuple(b.shape), dtype))
                row = None
            sig, tau_m = precond_maps(
                vol_shape, cfg.scheme, cfg.reg_z_over_reg, cfg.reg_time,
                fidelity_colsum=col,
                grouped=(cfg.norm != "aniso"),
            )
            sig = sig.astype(dtype) / pscale
            tau_m = tau_m.astype(dtype) / pscale
            if has_sums:
                floor = 1e-6 * jnp.maximum(jnp.max(row),
                                           jnp.asarray(1e-30, dtype))
                sig_A = (1.0 / jnp.maximum(row, floor)) / pscale
            else:
                sig_A = fidelity_row_precond(A_, tuple(b.shape), vol_shape,
                                             dtype) / pscale
        else:
            sig, tau_m, sig_A = sigma, tau, sigma_A

        # A is LINEAR (a CP requirement), so the over-relaxed projection
        # A(x_bar) = A(2 x_new - x) = 2 A(x_new) - A(x) comes from carried
        # sinogram images of the iterates — one forward + one adjoint per
        # iteration, and the loss reuses the same A(x_new)
        if fresh:
            x0 = init
            s0 = A_(x0)
            st = (x0, s0, s0, jnp.zeros_like(b),
                  jnp.zeros((vol_shape[0], Nd, vol_shape[1])
                            + tuple(vol_shape[2:]), dual_dtype))
            x_bar0 = x0
        else:
            x, x_bar, y_A, y_D = tuple(init)[:4]
            s_x = init.s_x if init.s_x is not None else A_(x)
            s_xb = init.s_x_bar if init.s_x_bar is not None else A_(x_bar)
            st = (x, s_x, s_xb, y_A, y_D.astype(dual_dtype))
            x_bar0 = x_bar

        def step(carry, x_bar, with_loss):
            x, sAx, sAx_bar, y_A, y_D = carry
            y_A = fidelity_dual_prox(y_A, sAx_bar, b, sig_A, fidelity, fw)
            p = y_D.astype(compute) + sig * D(x_bar.astype(compute),
                                              cfg.scheme, **kw)
            y_D = store_dual(dual_prox(p, reg, cfg.norm, sig,
                                       cfg.huber_delta), dual_dtype)
            x_new = x - tau_m * (A_T_(y_A)
                                 + D_T(y_D.astype(compute), cfg.scheme, **kw))
            if nonneg:
                x_new = jnp.maximum(x_new, 0.0)
            x_new = x_new.astype(dtype)
            x_bar = 2.0 * x_new - x
            s_new = A_(x_new)
            carry = (x_new, s_new, 2.0 * s_new - sAx, y_A, y_D)
            if not with_loss:
                return carry, x_bar, None
            loss = fidelity_loss(s_new, b, fidelity, fw) + reg * tv_norm(
                D(x_new, cfg.scheme, **kw), cfg.norm,
                huber_delta=cfg.huber_delta
            )
            return carry, x_bar, loss

        if loss_every == 1:
            def body(cb, _):
                c, xb = cb
                c, xb, loss = step(c, xb, True)
                return (c, xb), loss

            (final, x_bar_f), losses = jax.lax.scan(
                body, (st, x_bar0), length=n_iter)
        else:
            def chunk(cb, _):
                def inner(i, cb):
                    c, xb, _ = step(cb[0], cb[1], False)
                    return (c, xb)

                c, xb = jax.lax.fori_loop(0, loss_every - 1, inner, cb)
                c, xb, loss = step(c, xb, True)
                return (c, xb), loss

            (final, x_bar_f), losses = jax.lax.scan(
                chunk, (st, x_bar0), length=n_iter // loss_every)
        x, sAx, sAxb, y_A, y_D = final
        return (x, x_bar_f, y_A, y_D, sAx, sAxb), losses

    return run


def reg_discrepancy(
    A: Callable,
    b,
    vol_shape,
    noise_norm: float,
    n_iter: int = 150,
    reg0: float = 1e-2,
    n_bisect: int = 10,
    rtol: float = 0.05,
    **kw,
) -> "tuple[float, InverseResult]":
    """Choose ``reg`` by Morozov's discrepancy principle: the largest
    regularization whose solution still fits the data to the noise level,
    ``||A x_reg - b||_2 ~= noise_norm`` (= ``sigma * sqrt(b.size)`` for
    i.i.d. Gaussian noise of std ``sigma``).  The residual norm is
    monotone increasing in ``reg``, so a geometric bracket expansion from
    ``reg0`` followed by ``n_bisect`` log-space bisections converges fast;
    every solve warm-starts from the previous solution's full CP state
    (``cp_inverse(state=...)``), so later evaluations are cheap
    refinements.  Returns ``(reg, result)`` with ``|residual - noise_norm|
    <= rtol * noise_norm`` (or the closest bracketed value).

    ``**kw`` forwards to :func:`cp_inverse` (``cfg``, ``precond``,
    ``nonneg``, ``op_norm``, ...).  The l2 data term is assumed (the
    principle is defined for Gaussian noise); ``op_norm`` is estimated
    once here when neither it nor ``precond`` is given.
    """
    b = jnp.asarray(b)
    if not kw.get("precond") and kw.get("op_norm") is None:
        A_T = kw.get("A_T") or exact_transpose(A, vol_shape, b.dtype)
        kw = dict(kw, A_T=A_T,
                  op_norm=float(power_iteration(A, A_T, vol_shape,
                                                dtype=b.dtype)))
    # reg stays a TRACED argument of the run — one executable for the
    # whole sweep
    state = None

    def solve(reg):
        nonlocal state
        res = cp_inverse(A, b, vol_shape, n_iter=n_iter, reg=reg,
                         state=state, **kw)
        state = res.state
        return res, float(jnp.sqrt(jnp.sum(jnp.square(A(res.x) - b))))

    target = float(noise_norm)
    best = None

    def consider(reg_val, res, r):
        nonlocal best
        if best is None or abs(r - target) < best[0]:
            best = (abs(r - target), reg_val, res)

    lo = hi = float(reg0)
    res, r = solve(lo)
    consider(lo, res, r)
    if r < target:  # under-regularized at reg0: expand upward
        for _ in range(12):
            hi *= 10.0
            res, r = solve(hi)
            consider(hi, res, r)
            if r >= target:
                break
        lo = hi / 10.0
    else:           # over-regularized at reg0: expand downward
        for _ in range(12):
            lo /= 10.0
            res, r = solve(lo)
            consider(lo, res, r)
            if r <= target:
                break
        hi = lo * 10.0
    for _ in range(n_bisect):
        if best[0] <= rtol * target:
            break
        mid = float(np.sqrt(lo * hi))
        res, r = solve(mid)
        consider(mid, res, r)
        if r > target:
            hi = mid
        else:
            lo = mid
    return best[1], best[2]


def gaussian_blur_operator(vol_shape, sigma_px: float = 2.0, radius: int = 6,
                           dtype=jnp.float32) -> Callable:
    """A separable in-plane Gaussian blur as a linear forward operator
    (deblurring example; reflect-free zero boundary)."""
    r = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (r / sigma_px) ** 2)
    k = jnp.asarray(k / k.sum(), dtype)

    def blur(x):
        def conv_axis(v, axis):
            pad = [(0, 0)] * v.ndim
            pad[axis] = (radius, radius)
            vp = jnp.pad(v, pad)
            out = jnp.zeros_like(v)
            for i in range(2 * radius + 1):
                sl = [slice(None)] * v.ndim
                sl[axis] = slice(i, i + v.shape[axis])
                out = out + k[i] * vp[tuple(sl)]
            return out

        return conv_axis(conv_axis(x, 2), 3)

    return blur
