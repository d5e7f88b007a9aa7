"""Accelerator operator module — the jit-compiled replacement for
``pytv.tv_operators_GPU`` (``pytv/tv_operators_GPU.py:46-1052``).

Differences from the reference, by design (SURVEY.md sections 2.5, 3.2):

- jit-compiled and executable-cached instead of per-call cuDNN kernel chains;
- accepts numpy or jax arrays; returns numpy by default (reference behavior,
  ``tv_operators_GPU.py:247``) or keeps data device-resident with
  ``return_device_array=True`` (``return_pytorch_tensor`` is accepted as a
  drop-in alias for reference call sites, ``tv_operators_GPU.py:134``);
- jax-array input forces device-resident return, mirroring the reference's
  tensor-in/tensor-out rule (``tv_operators_GPU.py:181-182``).

Also provides ``type_like`` (``tv_operators_GPU.py:92-131``): match an
array's dtype/backend to a template across numpy and jax.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .ops import api as _api

__all__ = [
    "compute_L21_norm",
    "type_like",
    "D_upwind",
    "D_downwind",
    "D_central",
    "D_hybrid",
    "D_T_upwind",
    "D_T_downwind",
    "D_T_central",
    "D_T_hybrid",
]


def _is_device_array(x) -> bool:
    return isinstance(x, jax.Array)


def _want_device(img, kwargs) -> bool:
    # Pop both spellings; tensor-in forces tensor-out (tv_operators_GPU.py:181-182).
    want = bool(kwargs.pop("return_device_array", False))
    want = bool(kwargs.pop("return_pytorch_tensor", False)) or want
    return want or _is_device_array(img)


def _maybe_host(x, want_device):
    if want_device:
        return x
    return np.asarray(x)


def type_like(x, template):
    """Cast/convert ``x`` to the dtype and backend (numpy vs jax) of
    ``template`` — the 4-case table of ``tv_operators_GPU.py:92-131``
    generalized."""
    if _is_device_array(template):
        return jnp.asarray(x, dtype=template.dtype)
    template = np.asarray(template)
    if _is_device_array(x):
        x = np.asarray(x)
    return np.asarray(x, dtype=template.dtype)


def compute_L21_norm(D_img, return_array=False, **kwargs):
    """See ``pytv/tv_operators_GPU.py:46-90``; result moves to host unless a
    device return is requested (``:84-90``)."""
    want_device = _want_device(D_img, kwargs)
    out = _api.compute_L21_norm(jnp.asarray(D_img), return_array=return_array)
    if return_array:
        l21, arr = out
        return (l21, arr) if want_device else (float(l21), np.asarray(arr))
    return out if want_device else float(out)


def _make(base, name):
    def fn(
        img,
        reg_z_over_reg=1.0,
        reg_time=0,
        mask_static=False,
        factor_reg_static=0,
        **kwargs,
    ):
        want_device = _want_device(img, kwargs)
        if kwargs:
            raise TypeError(f"unexpected kwargs {sorted(kwargs)}")
        out = base(
            jnp.asarray(img),
            reg_z_over_reg=reg_z_over_reg,
            reg_time=reg_time,
            mask_static=_api.normalize_mask(mask_static),
            factor_reg_static=factor_reg_static,
        )
        return _maybe_host(out, want_device)

    fn.__name__ = name
    fn.__qualname__ = name
    fn.__doc__ = f"Accelerator {name}; parity with pytv/tv_operators_GPU.py."
    return fn


D_upwind = _make(_api.D_upwind, "D_upwind")
D_downwind = _make(_api.D_downwind, "D_downwind")
D_central = _make(_api.D_central, "D_central")
D_hybrid = _make(_api.D_hybrid, "D_hybrid")
D_T_upwind = _make(_api.D_T_upwind, "D_T_upwind")
D_T_downwind = _make(_api.D_T_downwind, "D_T_downwind")
D_T_central = _make(_api.D_T_central, "D_T_central")
D_T_hybrid = _make(_api.D_T_hybrid, "D_T_hybrid")
