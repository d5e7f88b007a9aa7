"""Subgradient-descent TV denoising — the reference's user-loop recipe
(``README.md:107-124``) promoted to a jit-compiled, device-resident solver.

The reference pays three host<->device round trips per iteration (SURVEY.md
section 3.2); here the whole iteration sequence is one ``lax.scan`` under
``jax.jit`` — state never leaves the device and the loss history comes back as
one stacked array (SURVEY.md section 5 "Metrics").
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.config import TVConfig
from ..ops.tv import tv_and_subgrad


class GDResult(NamedTuple):
    x: jax.Array        # denoised image (Nz, M, N_row, N_col)
    loss: jax.Array     # per-iteration loss history (n_iter,)
    tv: jax.Array       # per-iteration TV history (n_iter,)


def gd_step(x, x_noisy, *, reg, step_size, cfg: TVConfig, mask_static=None,
            weight_time=None):
    """One subgradient-descent update (``README.md:120-123``):

    ``x <- x - step*((x - x0) + reg*G)``; the returned loss uses the TV of the
    *pre-update* iterate and the fidelity of the post-update one, exactly as
    the reference loop records it.
    """
    tv, G = tv_and_subgrad(
        x, cfg.scheme, mask_static=mask_static, weight_time=weight_time,
        norm_type=cfg.norm, huber_delta=cfg.huber_delta, **cfg.kwargs()
    )
    x_new = x - step_size * ((x - x_noisy) + reg * G)
    loss = 0.5 * jnp.sum(jnp.square(x_new - x_noisy)) + reg * tv
    return x_new, loss, tv


@functools.partial(
    jax.jit, static_argnames=("n_iter", "cfg", "reg", "step_size",
                              "progress_every", "progress_fn")
)
def subgradient_descent(
    x_noisy,
    n_iter: int = 300,
    reg: float = 25.0,
    step_size: float = 5e-3,
    cfg: TVConfig = TVConfig(),
    x_init=None,
    mask_static=None,
    weight_time=None,
    progress_every: int = 0,
    progress_fn=None,
) -> GDResult:
    """Run ``n_iter`` subgradient-descent iterations on device.

    Defaults are the reference's README recipe (``README.md:108-116``:
    reg=25, step=5e-3, 300 iterations). ``x_init`` defaults to the noisy
    image, as in the recipe.

    ``progress_every=k`` invokes ``progress_fn(iteration, loss)`` on the
    host every k iterations from inside the device-resident scan (a gated
    ``jax.debug.callback``; zero cost when 0).  ``progress_fn`` defaults to
    a stderr printer; it must be hashable (a plain function, not a lambda
    built per call site, or jit re-traces).
    """
    from .progress import emit_progress

    x0 = x_noisy
    x = x0 if x_init is None else x_init

    def body(x, i):
        x_new, loss, tv = gd_step(x, x0, reg=reg, step_size=step_size,
                                  cfg=cfg, mask_static=mask_static,
                                  weight_time=weight_time)
        emit_progress(i, loss, progress_every, progress_fn)
        return x_new, (loss, tv)

    x_final, (losses, tvs) = jax.lax.scan(body, x, jnp.arange(n_iter))
    return GDResult(x=x_final, loss=losses, tv=tvs)
