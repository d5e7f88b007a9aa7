"""Utility-layer tests: images, profiling models, finiteness checks,
multihost no-op bootstrap, and example scripts."""

import runpy
import sys

import numpy as np
import pytest

from pytv4d_tpu.utils import (
    IterationTimer,
    as_volume,
    assert_finite,
    cameraman,
    cp_traffic_model,
    roofline_fraction,
    synthetic_phantom,
)


def test_cameraman_contract():
    """Reference contract (``pytv/utils.py:46-55``): 256x256 integer image."""
    img = cameraman()
    assert img.shape == (256, 256)
    assert img.dtype == np.int64
    assert 0 <= img.min() and img.max() <= 255


def test_synthetic_phantom_deterministic():
    a, b = synthetic_phantom(64), synthetic_phantom(64)
    np.testing.assert_array_equal(a, b)
    assert a.min() >= 7 and a.max() <= 253


def test_as_volume():
    v = as_volume(np.ones((8, 8)), Nz=3, M=2)
    assert v.shape == (3, 2, 8, 8)
    v[0, 0, 0, 0] = 5  # must be writable (a copy, not a broadcast view)


def test_traffic_model_and_roofline():
    """The CP byte models (two-pass: 32 f32 volume-equivalents at Nd = 8;
    unfused jnp estimate: 12 + 3 Nd = 36) and the roofline share against
    the H100's published 3.35 TB/s."""
    vox = 8 * 4 * 64 * 64
    b = cp_traffic_model((8, 4, 64, 64), Nd=8)
    assert b == 32 * 4 * vox
    assert cp_traffic_model((8, 4, 64, 64), Nd=8, model="jnp") == 36 * 4 * vox
    # bf16 duals: the 3 Nd dual-volume passes halve
    assert cp_traffic_model((8, 4, 64, 64), Nd=8, dual_dtype="bfloat16") == (
        (8 * 4 + 24 * 2) * vox)
    with pytest.raises(ValueError, match="model"):
        cp_traffic_model((8, 4, 64, 64), Nd=8, model="actual")
    frac = roofline_fraction(b, 100.0, kind="NVIDIA H100 80GB HBM3")
    assert frac == pytest.approx(b * 100.0 / 3.35e12)


def test_device_peaks_table():
    """Peaks come from one table keyed by device_kind; a device it does
    not know (the CPU here) is an error, never a default."""
    from pytv4d_tpu.utils import device_peaks

    h100 = device_peaks("NVIDIA H100 80GB HBM3")
    assert h100 == {"hbm_gbps": 3350.0, "bf16_tflops": 989.0}
    with pytest.raises(ValueError, match="no published peaks"):
        device_peaks()
    with pytest.raises(ValueError, match="no published peaks"):
        roofline_fraction(1, 1.0, kind="cpu")


def test_assert_finite():
    assert_finite({"a": np.ones(3)}, "state")
    with pytest.raises(FloatingPointError, match="state"):
        assert_finite({"a": np.array([1.0, np.inf])}, "state")


def test_iteration_timer():
    import jax.numpy as jnp

    def run_n(n):
        return jnp.arange(n, dtype=jnp.float32) if n else jnp.zeros(1)

    its = IterationTimer(run_n, warmup_iters=1).measure(4, repeats=1)
    assert its > 0


def test_multihost_initialize_single_process(monkeypatch):
    from pytv4d_tpu.parallel import multihost

    # the JAX coordinator variables declare a cluster; nothing else does
    for var in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert not multihost.cluster_configured()
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    assert multihost.cluster_configured()
    monkeypatch.delenv("JAX_NUM_PROCESSES")

    multihost.initialize()  # must no-op cleanly in a single process
    assert multihost._initialized


def test_multihost_initialize_raises_on_misconfigured_cluster(monkeypatch):
    """A declared cluster whose bootstrap fails must raise, never silently
    degrade to single-process (wrong-mesh results downstream)."""
    import jax

    from pytv4d_tpu.parallel import multihost

    monkeypatch.setattr(multihost, "_initialized", False)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "badhost:1234")

    def boom(**kwargs):
        raise RuntimeError("connection refused")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    with pytest.raises(RuntimeError, match="refusing to silently degrade"):
        multihost.initialize()
    assert not multihost._initialized


def test_example_scripts_run():
    """The scheme-math and sharded examples must execute end to end (the
    getting-started one has its own full-tier test below; it just takes
    longer)."""
    for script in ("examples/b_schemes_math.py", "examples/c_4d_sharded.py",
                   "examples/d_ct_reconstruction.py", "examples/e_tgv.py",
                   "examples/f_inverse_problems.py"):
        runpy.run_path(script, run_name="__main__")


@pytest.mark.full
def test_getting_started_script_runs():
    """examples/a_getting_started.py (the README user journey: TV values,
    GD/CP/ADMM cameraman denoising, operator forms, autodiff TV, TV-L1,
    gap certificate, TGV) executes end to end — ~12 s on forced CPU, so
    full tier."""
    runpy.run_path("examples/a_getting_started.py", run_name="__main__")


def test_compile_cache_and_warm_compile(tmp_path, monkeypatch):
    """enable_compile_cache points the persistent cache at
    $JAX_COMPILATION_CACHE_DIR (entries appear after a compile) and
    warm_compile pre-compiles a jitted solver from ShapeDtypeStructs
    without running it."""
    import jax
    import jax.numpy as jnp

    from pytv4d_tpu.solvers.cp import chambolle_pock
    from pytv4d_tpu.utils import enable_compile_cache, warm_compile

    d = str(tmp_path / "jc")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", d)
    assert enable_compile_cache(min_compile_time_secs=0.0) == d
    assert jax.config.jax_compilation_cache_dir == d
    try:
        compiled = warm_compile(
            chambolle_pock,
            jax.ShapeDtypeStruct((1, 1, 32, 32), jnp.float32),
            n_iter=5,
        )
        assert hasattr(compiled, "as_text")
        assert len(list((tmp_path / "jc").iterdir())) >= 1
    finally:
        jax.config.update("jax_compilation_cache_dir", None)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir_rule(tmp_path, monkeypatch, env_set):
    """The cache lives in $JAX_COMPILATION_CACHE_DIR when it is set, and
    otherwise in the fixed <checkout>/.jax_cache — never a temporary or
    per-process directory."""
    import os

    from pytv4d_tpu.utils import compile_cache

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.cache_dir() == str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert compile_cache.cache_dir() == os.path.join(repo, ".jax_cache")
        assert compile_cache.cache_dir() == compile_cache.cache_dir()


def test_tgv_traffic_model_counts():
    """Plane counts of the two-pass TGV traffic model, hand-derived from
    the arrays each pass reads and writes."""
    from pytv4d_tpu.utils.profiling import tgv_traffic_model

    vox = 2 * 3 * 8 * 16
    # 4d: n=4, n_q=10 -> PQ (1+8+10)+(4+10); XW (2+8+10)+(2+8) = 63 planes
    assert tgv_traffic_model((2, 3, 8, 16), "4d") == 63 * vox * 4
    # 2d: n=2, n_q=3 -> (1+4+3)+(2+3)+(2+4+3)+(2+4) = 28
    assert tgv_traffic_model((2, 3, 8, 16), "2d") == 28 * vox * 4
    # bf16 halves bytes
    assert tgv_traffic_model((2, 3, 8, 16), "3d", dtype="bfloat16") == (
        tgv_traffic_model((2, 3, 8, 16), "3d") // 2)
