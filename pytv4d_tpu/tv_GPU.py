"""Accelerator TV module — the jit-compiled replacement for ``pytv.tv_GPU``
(``pytv/tv_GPU.py:47-376``).

Returns ``(tv, G[, grad_norms])``; host numpy by default (reference behavior,
``tv_GPU.py:129-139``), device-resident with ``return_device_array=True``
(``return_pytorch_tensor`` accepted as a drop-in alias) or when the input is
already a jax array.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .ops import api as _api
from .tv_operators_GPU import _want_device

__all__ = ["tv_upwind", "tv_downwind", "tv_central", "tv_hybrid"]


def _make(base, name):
    def fn(
        img,
        mask=[],
        reg_z_over_reg=1.0,
        reg_time=0.0,
        mask_static=False,
        factor_reg_static=0,
        return_grad_norms=False,
        **kwargs,
    ):
        want_device = _want_device(img, kwargs)
        if kwargs:
            raise TypeError(f"unexpected kwargs {sorted(kwargs)}")
        out = base(
            jnp.asarray(img),
            mask=_api.normalize_mask(mask),
            reg_z_over_reg=reg_z_over_reg,
            reg_time=reg_time,
            mask_static=_api.normalize_mask(mask_static),
            factor_reg_static=factor_reg_static,
            return_grad_norms=return_grad_norms,
        )
        if want_device:
            return out
        if return_grad_norms:
            tv, G, norms = out
            return float(tv), np.asarray(G), np.asarray(norms)
        tv, G = out
        return float(tv), np.asarray(G)

    fn.__name__ = name
    fn.__qualname__ = name
    fn.__doc__ = f"Accelerator {name}; parity with pytv/tv_GPU.py."
    return fn


tv_upwind = _make(_api.tv_upwind, "tv_upwind")
tv_downwind = _make(_api.tv_downwind, "tv_downwind")
tv_central = _make(_api.tv_central, "tv_central")
tv_hybrid = _make(_api.tv_hybrid, "tv_hybrid")
