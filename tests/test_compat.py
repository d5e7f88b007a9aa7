"""Drop-in compatibility surface tests: the module layout, kwargs, and
return conventions a reference (PyTV-4D) user relies on
(``pytv/__init__.py:43-63``, SURVEY.md section 2.2)."""

import jax
import numpy as np
import pytest

import pytv4d_tpu as pytv


def test_reference_module_layout():
    """Every name a reference user touches must exist."""
    for mod in ("tv_CPU", "tv_GPU", "tv_operators_CPU", "tv_operators_GPU",
                "utils"):
        assert hasattr(pytv, mod), mod
    for scheme in ("upwind", "downwind", "central", "hybrid"):
        assert hasattr(pytv.tv_CPU, f"tv_{scheme}")
        assert hasattr(pytv.tv_GPU, f"tv_{scheme}")
        assert hasattr(pytv.tv_operators_CPU, f"D_{scheme}")
        assert hasattr(pytv.tv_operators_CPU, f"D_T_{scheme}")
        assert hasattr(pytv.tv_operators_GPU, f"D_{scheme}")
    assert callable(pytv.utils.cameraman) and callable(pytv.cameraman)
    assert callable(pytv.run_CPU_tests) and callable(pytv.run_GPU_tests)
    assert callable(pytv.tv_operators_GPU.compute_L21_norm)


def test_numpy_in_numpy_out_defaults():
    """GPU-module functions take numpy and return numpy by default
    (``tv_operators_GPU.py:247``); tensor mode via the legacy kwarg."""
    img = np.random.default_rng(0).random((2, 2, 8, 8))
    tv, G = pytv.tv_GPU.tv_hybrid(img, reg_time=0.5)
    assert isinstance(tv, float) and isinstance(G, np.ndarray)

    D = pytv.tv_operators_GPU.D_hybrid(img)
    assert isinstance(D, np.ndarray)
    D_dev = pytv.tv_operators_GPU.D_hybrid(img, return_pytorch_tensor=True)
    assert isinstance(D_dev, jax.Array)
    # jax-array input forces device output (tv_operators_GPU.py:181-182)
    D_dev2 = pytv.tv_operators_GPU.D_hybrid(D_dev[:, 0])
    assert isinstance(D_dev2, jax.Array)


def test_l21_host_scalar():
    img = np.random.default_rng(1).random((2, 1, 8, 8))
    D = pytv.tv_operators_GPU.D_hybrid(img)
    l21 = pytv.tv_operators_GPU.compute_L21_norm(D)
    assert isinstance(l21, float)
    l21_2, arr = pytv.tv_operators_GPU.compute_L21_norm(D, return_array=True)
    assert isinstance(arr, np.ndarray) and arr.shape == img.shape


def test_type_like():
    from pytv4d_tpu.tv_operators_GPU import type_like

    x64 = np.ones(3, np.float64)
    x32 = np.ones(3, np.float32)
    assert type_like(x64, x32).dtype == np.float32
    import jax.numpy as jnp

    dev = jnp.ones(3, jnp.float32)
    out = type_like(x64, dev)
    assert isinstance(out, jax.Array) and out.dtype == jnp.float32
    back = type_like(dev, x64)
    assert isinstance(back, np.ndarray) and back.dtype == np.float64


def test_return_grad_norms_device_mode():
    img = np.random.default_rng(2).random((2, 2, 8, 8))
    tv, G, norms = pytv.tv_GPU.tv_hybrid(img, reg_time=0.5,
                                         return_grad_norms=True)
    assert isinstance(norms, np.ndarray) and norms.shape == img.shape
    out = pytv.tv_GPU.tv_hybrid(img, return_grad_norms=True,
                                return_pytorch_tensor=True)
    assert all(isinstance(o, jax.Array) for o in out)


def test_version_and_config_exports():
    assert isinstance(pytv.__version__, str)
    cfg = pytv.TVConfig(scheme="central", reg_time=0.5)
    assert cfg.scheme == "central"
    with pytest.raises(ValueError):
        pytv.TVConfig(scheme="nope")
    assert pytv.SCHEMES == ("upwind", "downwind", "central", "hybrid")


def test_tests_module_alias():
    """Reference users call ``pytv.tests.run_CPU_tests`` (pytv/__init__.py:57)."""
    import pytv4d_tpu.tests as t

    assert callable(t.run_CPU_tests) and callable(t.run_GPU_tests)
    assert callable(pytv.tests.test_equal)
