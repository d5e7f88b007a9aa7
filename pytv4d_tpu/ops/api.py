"""Jit-compiled device-native entry points.

The reference re-launches unfused kernels and round-trips host<->device on
every call (``tv_operators_GPU.py:179,247`` — SURVEY.md section 3.2).  Here
every public function is staged through ``jax.jit`` with the scheme/reg
configuration static, so repeated solver calls hit the XLA executable cache
and data stays device-resident.
"""

from __future__ import annotations

import jax

from . import operators as _ops
from . import tv as _tv

_STATIC_D = ("scheme", "reg_z_over_reg", "reg_time", "factor_reg_static")
_STATIC_TV = _STATIC_D + ("return_grad_norms", "norm_type", "huber_delta")

D = jax.jit(_ops.D, static_argnames=_STATIC_D)
D_T = jax.jit(_ops.D_T, static_argnames=_STATIC_D)
compute_L21_norm = jax.jit(_ops.compute_L21_norm, static_argnames=("return_array",))
_tv_jnp = jax.jit(_tv.tv_and_subgrad, static_argnames=_STATIC_TV)


def tv_and_subgrad(img, scheme="hybrid", mask=None, reg_z_over_reg=1.0,
                   reg_time=0.0, mask_static=None, factor_reg_static=0.0,
                   weight_time=None, return_grad_norms=False,
                   norm_type="iso", huber_delta=1.0):
    """tv + subgradient, jit-compiled (``ops.tv.tv_and_subgrad``)."""
    return _tv_jnp(img, scheme=scheme, mask=mask,
                   reg_z_over_reg=reg_z_over_reg, reg_time=reg_time,
                   mask_static=mask_static,
                   factor_reg_static=factor_reg_static,
                   weight_time=weight_time,
                   return_grad_norms=return_grad_norms,
                   norm_type=norm_type, huber_delta=huber_delta)


def normalize_mask(mask_static):
    """Map the reference's bool sentinel (``tv_operators_CPU.py:148``) to None
    so the jitted functions see a static "no mask" signature."""
    if _ops.mask_enabled(mask_static):
        return mask_static
    return None


def _scheme_fn(base, scheme):
    def fn(img, **kwargs):
        kwargs["mask_static"] = normalize_mask(kwargs.get("mask_static"))
        if "mask" in kwargs:
            kwargs["mask"] = normalize_mask(kwargs.get("mask"))
        return base(img, scheme=scheme, **kwargs)

    fn.__name__ = f"{getattr(base, '__name__', 'fn')}_{scheme}"
    fn.__qualname__ = fn.__name__
    return fn


D_upwind = _scheme_fn(D, "upwind")
D_downwind = _scheme_fn(D, "downwind")
D_central = _scheme_fn(D, "central")
D_hybrid = _scheme_fn(D, "hybrid")
D_T_upwind = _scheme_fn(D_T, "upwind")
D_T_downwind = _scheme_fn(D_T, "downwind")
D_T_central = _scheme_fn(D_T, "central")
D_T_hybrid = _scheme_fn(D_T, "hybrid")
tv_upwind = _scheme_fn(tv_and_subgrad, "upwind")
tv_downwind = _scheme_fn(tv_and_subgrad, "downwind")
tv_central = _scheme_fn(tv_and_subgrad, "central")
tv_hybrid = _scheme_fn(tv_and_subgrad, "hybrid")
