"""Tracing / profiling / roofline helpers (SURVEY.md section 5: the reference
has only ad-hoc ``time.time()`` deltas inside tests, ``pytv/tests.py:261-285``).

- :func:`trace` — context manager around ``jax.profiler`` producing a
  TensorBoard-loadable trace directory.
- :class:`IterationTimer` — steady-state iterations/s of a whole
  device-resident scan, synchronised with ``jax.block_until_ready``.
- :func:`cp_traffic_model` / :func:`tgv_traffic_model` — device-independent
  bytes-moved models of one CP / TGV-2 iteration.
- :func:`device_peaks` / :func:`roofline_fraction` — the published peaks of
  the accelerators this package is measured on, and a step's share of them.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

# Published peaks per ``jax.Device.device_kind``: device-memory bandwidth in
# GB/s and dense bf16 tensor-core rate in TFLOP/s.  Source: NVIDIA H100
# Tensor Core GPU data sheet, SXM part, dense rates without sparsity, at the
# full 700 W power limit.  A device missing here is an error, not a default.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "bf16_tflops": 989.0},
}


def device_peaks(kind: Optional[str] = None) -> dict:
    """Peaks of ``kind`` (default: the first JAX device's ``device_kind``);
    raises ``ValueError`` for a device the table does not know."""
    if kind is None:
        kind = jax.devices()[0].device_kind
    try:
        return DEVICE_PEAKS[kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {kind!r}; known: "
            f"{sorted(DEVICE_PEAKS)}"
        ) from None


@contextlib.contextmanager
def trace(log_dir: str):
    """``with profiling.trace('/tmp/trace'): run()`` then inspect with
    TensorBoard / xprof."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class IterationTimer:
    """Measure steady-state iterations/s of ``run_n(n) -> arrays``.

    ``run_n`` must execute n device-resident iterations (e.g. a jitted
    ``lax.scan``) and return its output arrays; each run is timed up to
    ``jax.block_until_ready`` of that output.
    """

    def __init__(self, run_n: Callable[[int], object], warmup_iters: int = 5):
        self.run_n = run_n
        self.warmup_iters = warmup_iters

    def measure(self, n_iter: int, repeats: int = 3) -> float:
        jax.block_until_ready(self.run_n(self.warmup_iters))
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(self.run_n(n_iter))
            best = min(best, time.perf_counter() - t0)
        return n_iter / best


def cp_traffic_model(shape, Nd: int, dtype=jnp.float32, dual_dtype=None,
                     model: str = "two_pass") -> int:
    """Bytes one CP denoising iteration must move through device memory.

    ``model='two_pass'``: the least traffic of a split-adjoint two-pass
    step, each array touched once per pass — pass A reads x, x0, y_A, y_D
    and writes y_A, y_D; pass B reads x, x0, y_A, y_D and writes x.  With
    f32 and Nd = 8 that is 32 volume-equivalents.  ``model='jnp'``: the
    unfused estimate of the plain ``jax.numpy`` step, 12 + 3 Nd
    volume-equivalents (36 at Nd = 8).  ``dual_dtype`` scales the y_D
    terms (bf16 duals)."""
    vox = int(np.prod(shape))
    bpe = jnp.dtype(dtype).itemsize
    dual_bpe = jnp.dtype(dual_dtype).itemsize if dual_dtype else bpe
    if model == "jnp":
        return int((6 * 2 + 3 * Nd) * vox * bpe)
    if model != "two_pass":
        raise ValueError(f"model must be 'two_pass' or 'jnp', got {model!r}")
    pass_a = 4 * bpe + 2 * Nd * dual_bpe
    pass_b = 4 * bpe + Nd * dual_bpe
    return int((pass_a + pass_b) * vox)


def tgv_traffic_model(shape, mode: str, dtype=jnp.float32) -> int:
    """Bytes one TGV-2 iteration must move in a two-pass form, each array
    touched once per pass: pass PQ reads xb, wb, p, q and writes p, q;
    pass XW reads x, x0, p, w, q and writes x, xb, w, wb."""
    n = {"2d": 2, "3d": 3, "4d": 4}[mode]
    n_q = n + n * (n - 1) // 2
    vox = int(np.prod(shape))
    bpe = jnp.dtype(dtype).itemsize
    planes = (1 + 2 * n + n_q) + (n + n_q) + (2 + 2 * n + n_q) + (2 + 2 * n)
    return int(planes * vox * bpe)


def roofline_fraction(bytes_per_iter: int, iters_per_s: float,
                      kind: Optional[str] = None) -> float:
    """Achieved bytes/s over the device's published memory bandwidth
    (:func:`device_peaks`)."""
    peak = device_peaks(kind)["hbm_gbps"] * 1e9
    return bytes_per_iter * iters_per_s / peak
