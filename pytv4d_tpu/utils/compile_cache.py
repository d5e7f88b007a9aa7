"""Persistent-compilation-cache ergonomics.

XLA compiles of the 4D solvers and CT projectors take seconds to minutes
per new program shape (the reference has no compile step at all —
``pytv/tv_operators_CPU.py`` is eager NumPy).  JAX's persistent cache
turns a later process's compile into a disk load.

Usage (once, before the first jit)::

    from pytv4d_tpu.utils import enable_compile_cache
    enable_compile_cache()

The cache lives where ``JAX_COMPILATION_CACHE_DIR`` says when it is set,
and otherwise in the fixed directory ``.jax_cache`` at the root of this
checkout (listed in ``.gitignore``): a directory that moves between runs
never hits.

``warm_compile`` pre-lowers a solver for a shape so first real use is
instant (e.g. in a deploy step or a container build).
"""

from __future__ import annotations

import os

import jax

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent cache uses: ``$JAX_COMPILATION_CACHE_DIR``
    when set, else ``<checkout>/.jax_cache``."""
    return os.environ.get(CACHE_ENV) or REPO_CACHE_DIR


def enable_compile_cache(min_compile_time_secs: float = 1.0) -> str:
    """Turn on JAX's persistent compilation cache in :func:`cache_dir`.
    Programs whose compile took longer than ``min_compile_time_secs`` are
    cached; returns the directory."""
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_time_secs)
    # cache everything that crossed the time threshold, however small
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path


def warm_compile(solver, *args, **kwargs):
    """Trace + compile a jitted solver for concrete example arguments WITHOUT
    running it: ``warm_compile(chambolle_pock, jax.ShapeDtypeStruct((32, 8,
    256, 256), jnp.float32), n_iter=300)``.  Arguments may be
    ``ShapeDtypeStruct``s (no memory allocated) or real arrays; static
    kwargs (n_iter, cfg, reg, ...) must match later calls exactly.  With the
    persistent cache enabled the compiled program also lands on disk.

    Solvers with an eager validation wrapper around their jitted core
    (``chambolle_pock``) expose it as ``solver._jit`` — used here
    automatically so AOT lowering still works."""
    solver = getattr(solver, "_jit", solver)
    return solver.lower(*args, **kwargs).compile()
