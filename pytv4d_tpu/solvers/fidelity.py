"""Data-fidelity terms for the primal-dual inverse-problem solvers.

The reference's solver recipes are least-squares only
(``/root/reference/README.md:139-158``: ``1/2 ||x - x0||^2``).  Real
measurement noise often is not Gaussian — CT photon counts are Poisson,
spike/readout corruption is heavy-tailed — so ``cp_inverse`` /
``tgv_inverse`` (and the CT wrappers) accept a ``fidelity`` choice:

- ``'l2'``  — ``F(v) = weight/2 ||v - b||^2`` (Gaussian noise; the default,
  bit-identical to the historical path at ``weight=1``),
- ``'l1'``  — ``F(v) = weight ||v - b||_1`` (impulsive / salt-and-pepper /
  heavy-tailed noise; the TV-L1 model of Chan & Esedoglu 2005),
- ``'kl'``  — ``F(v) = weight * sum(v - b log v)`` (Poisson log-likelihood,
  the physically correct model for photon-count CT; Chambolle & Pock 2011
  section 6.3.2 give the closed-form conjugate prox used here).

Chambolle-Pock handles any convex ``F`` through the prox of its convex
conjugate ``F*`` — the step rule depends only on the linear operator, so
the fidelity is a drop-in swap of two lines of the iteration (dual update
and loss).  ``weight`` may be a scalar or a per-measurement array
broadcastable to ``b`` (e.g. ray-dependent noise levels); every formula
below is pointwise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

FIDELITIES = ("l2", "l1", "kl")


def _concrete_any(x, op) -> bool:
    """``any(op(x))`` for concrete inputs; False (check skipped) for
    tracers.  Concrete jax Arrays reduce ON DEVICE (one scalar crosses the
    host boundary — never the full measurement array, which may be large
    or multi-host sharded); everything else goes through
    numpy so the check also works for static python values inside a jit
    trace."""
    if isinstance(x, jax.core.Tracer):
        return False
    if isinstance(x, jax.Array):
        return bool(jnp.any(op(x)))
    return bool(np.any(op(np.asarray(x))))


def validate_fidelity(fidelity: str, b, weight) -> None:
    """Eager argument checks.  Value checks (``weight > 0``, ``b >= 0`` for
    'kl') run only on concrete inputs; traced inputs (solver called under
    the user's jit/vmap) skip them."""
    if fidelity not in FIDELITIES:
        raise ValueError(
            f"fidelity must be one of {FIDELITIES}, got {fidelity!r}"
        )
    if _concrete_any(weight, lambda w: w <= 0):
        raise ValueError("fidelity_weight must be positive")
    if fidelity == "kl" and _concrete_any(b, lambda v: v < 0):
        raise ValueError(
            "fidelity='kl' requires nonnegative data b (Poisson counts)"
        )


def fidelity_dual_prox(y, Ax, b, sigma, fidelity: str = "l2", weight=1.0):
    """``prox_{sigma F*}(y + sigma A x_bar)`` for the data term ``F``.

    ``sigma`` may be a scalar or a per-measurement map (the diagonally
    preconditioned solvers pass reciprocal row sums).  Derivations:

    - l2: ``F* = <p, b> + |p|^2/(2w)`` so the prox is the linear resolvent
      ``(y + sigma (Ax - b)) / (1 + sigma/w)`` — the reference recipe's
      fidelity line at ``w=1`` (``/root/reference/README.md:148``).
    - l1: ``F* = <p, b> + indicator(|p|_inf <= w)`` so the prox is the
      box projection ``clip(y + sigma (Ax - b), -w, w)``.
    - kl: ``F*(p) = -w b log(1 - p/w)`` on ``p < w``; the prox optimality
      condition is the pointwise quadratic ``p^2 - (w+q) p + qw - sigma w b
      = 0`` with root ``p = ((w+q) - sqrt((q-w)^2 + 4 sigma w b)) / 2``
      (always < w, so the domain constraint is automatic).
    """
    if fidelity == "l1":
        return jnp.clip(y + sigma * (Ax - b), -weight, weight)
    if fidelity == "kl":
        q = y + sigma * Ax
        s = q - weight
        return 0.5 * (q + weight
                      - jnp.sqrt(s * s + 4.0 * sigma * weight * b))
    # l2 — the residual form keeps weight=1.0 bit-identical to the
    # historical unweighted path
    return (y + sigma * (Ax - b)) / (1.0 + sigma / weight)


def fidelity_loss(Ax, b, fidelity: str = "l2", weight=1.0):
    """The data term of the reported objective.

    For ``'kl'`` the nonnegative Csiszar form ``sum w (Ax - b + b log(b /
    Ax))`` is reported — it differs from the optimized ``sum w (Ax - b log
    Ax)`` by a constant in x (``sum w (b log b - b)``), is zero at a
    perfect fit, and is finite for ``b = 0`` bins."""
    if fidelity == "l1":
        return jnp.sum(weight * jnp.abs(Ax - b))
    if fidelity == "kl":
        ax = jnp.maximum(Ax, 1e-30)
        ent = jnp.where(b > 0.0,
                        b * jnp.log(jnp.maximum(b, 1e-30) / ax), 0.0)
        return jnp.sum(weight * (Ax - b + ent))
    return 0.5 * jnp.sum(weight * jnp.square(Ax - b))


def fidelity_conjugate(y, b, fidelity: str = "l2", weight=1.0):
    """``(y_feasible, F*(y_feasible))`` — the convex conjugate of the data
    term, with ``y`` first projected onto ``dom F*`` so the returned value
    is finite (and the duality bound valid) for ANY input.  The conjugate
    is taken of the same primal form :func:`fidelity_loss` reports:

    - l2: ``F* = <y, b> + sum y^2/(2w)`` (finite everywhere; measurements
      with ``w = 0`` force ``y = 0`` there),
    - l1: ``F* = <y, b>`` on the box ``|y| <= w`` (projection = clip),
    - kl (Csiszar-form primal): ``F* = -sum w b log(1 - y/w)`` on
      ``y <= w`` (strict where ``b > 0``); projection = clamp to
      ``(1 - 1e-6) w``.

    Used by the duality-gap certificates (``solvers.cp.pd_gap``,
    ``solvers.inverse.pd_gap_inverse``)."""
    w = jnp.asarray(weight, jnp.asarray(y).dtype)
    if fidelity == "l1":
        y = jnp.clip(y, -w, w)
        return y, jnp.sum(y * b)
    if fidelity == "kl":
        live = w > 0
        y = jnp.where(live, jnp.minimum(y, (1.0 - 1e-6) * w), 0.0)
        safe_w = jnp.where(live, w, 1.0)  # dead rows force y = 0, F* = 0
        val = -jnp.sum(jnp.where(
            live & (b > 0.0), w * b * jnp.log1p(-y / safe_w), 0.0))
        return y, val
    live = w > 0
    y = jnp.where(live, y, 0.0)
    val = jnp.sum(y * b) + jnp.sum(
        jnp.where(live, jnp.square(y) / (2.0 * jnp.where(live, w, 1.0)),
                  0.0))
    return y, val
