"""Compat alias: the reference exposes its battery as the ``pytv.tests``
module (``pytv/tests.py``, re-exported by ``pytv/__init__.py:57``); this
framework's implementation lives in :mod:`pytv4d_tpu.testing`."""

from .testing import (  # noqa: F401
    run_CPU_tests,
    run_GPU_tests,
    test_2D_to_3D,
    test_cross_implementation,
    test_equal,
    test_operator_transpose,
    test_transpose,
)
