"""pytv4d_tpu — a JAX total-variation framework for 2D/3D/4D imaging.

A ground-up JAX/XLA re-design with the full capability surface of
eboigne/PyTV-4D v1.1.2 (reference layer map in SURVEY.md): the four TV
discretization schemes (upwind / downwind / central / hybrid), the discrete
gradient D and its exact adjoint D_T, the L2,1 norm, TV value + subgradient,
first-class jit-compiled solvers (subgradient descent, Chambolle-Pock, ADMM),
and (z, t) device-mesh sharding with halo exchange.

Drop-in compatibility: ``tv_CPU`` / ``tv_operators_CPU`` (numpy float64,
bit-exact vs the reference CPU path) and ``tv_GPU`` / ``tv_operators_GPU``
(jit-compiled accelerator modules) mirror ``pytv``'s module layout
(``pytv/__init__.py:43-63``), so ``import pytv4d_tpu as pytv`` works for
reference call sites.
"""

__version__ = "0.1.0"

from . import core, ops, utils
from .core.config import TVConfig
from .core.schemes import SCHEMES, num_channels, operator_norm_bound_sq

# Device-native jit-compiled API (the recommended entry points).
from .ops.api import (
    D,
    D_T,
    D_central,
    D_downwind,
    D_hybrid,
    D_T_central,
    D_T_downwind,
    D_T_hybrid,
    D_T_upwind,
    D_upwind,
    compute_L21_norm,
    tv_and_subgrad,
    tv_central,
    tv_downwind,
    tv_hybrid,
    tv_upwind,
)
from .ops.tv import make_tv

# Reference-layout compat modules (``pytv.tv_CPU`` etc.).
from . import tests, tv_CPU, tv_GPU, tv_operators_CPU, tv_operators_GPU

# utils / tests exported at package level like the reference
# (``pytv/__init__.py:59-60``).
from .utils.images import cameraman
from .testing import run_CPU_tests, run_GPU_tests

# Solvers, models, parallel.
from . import solvers, models, parallel
