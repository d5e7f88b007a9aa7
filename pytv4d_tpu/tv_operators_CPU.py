"""Drop-in compat module for ``pytv.tv_operators_CPU``.

Pure-NumPy float64 execution of the shared operator core — bit-exact against
the reference CPU path (``pytv/tv_operators_CPU.py:45-658``; reproduces
``README.md:91``'s ``tv_hybrid`` value 532166.8251801673 exactly).  Use the
device-native API (``pytv4d_tpu.ops.api`` / ``tv_GPU``) for performance.
"""

from __future__ import annotations

import numpy as np

from .ops import operators as _ops

__all__ = [
    "compute_L21_norm",
    "D_upwind",
    "D_downwind",
    "D_central",
    "D_hybrid",
    "D_T_upwind",
    "D_T_downwind",
    "D_T_central",
    "D_T_hybrid",
]


def compute_L21_norm(D_img, return_array=False):
    """See ``pytv/tv_operators_CPU.py:45-74``."""
    return _ops.compute_L21_norm(np.asarray(D_img), return_array=return_array, xp=np)


def _make(base, scheme):
    def fn(img, reg_z_over_reg=1.0, reg_time=0, mask_static=False, factor_reg_static=0):
        return base(
            np.asarray(img),
            scheme,
            reg_z_over_reg=reg_z_over_reg,
            reg_time=reg_time,
            mask_static=mask_static,
            factor_reg_static=factor_reg_static,
            xp=np,
        )

    fn.__name__ = f"{base.__name__}_{scheme}"
    fn.__qualname__ = fn.__name__
    fn.__doc__ = (
        f"NumPy-backend {base.__name__}(scheme={scheme!r}); reference parity "
        f"with pytv/tv_operators_CPU.py."
    )
    return fn


D_upwind = _make(_ops.D, "upwind")
D_downwind = _make(_ops.D, "downwind")
D_central = _make(_ops.D, "central")
D_hybrid = _make(_ops.D, "hybrid")
D_T_upwind = _make(_ops.D_T, "upwind")
D_T_downwind = _make(_ops.D_T, "downwind")
D_T_central = _make(_ops.D_T, "central")
D_T_hybrid = _make(_ops.D_T, "hybrid")
