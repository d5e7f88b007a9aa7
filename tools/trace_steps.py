"""Where the device time of the main solves goes, from a profiler trace.

    python tools/trace_steps.py [--n-iter 10] [--out FILE] [--only NAME ...]

Traces, on the first device, ``--n-iter`` iterations of each workload
(after a warm-up call that compiles it):

- ``cp_f32``      ``chambolle_pock`` at (32,8,256,256), hybrid + time, f32;
- ``cp_bf16dual`` the same with ``dual_dtype='bfloat16'``;
- ``tgv4d``       ``tgv_denoise(axes='4d')`` at (32,8,256,256);
- ``ct_parallel`` spectral ``cp_reconstruct`` at (16,4,512,512) x 96 angles
  with ``op_norm`` given (the power method is not in the window).

Each trace is written with ``jax.profiler.trace(create_perfetto_trace=
True)`` and reduced here: the device's kernel events (all its streams)
are merged into busy intervals, giving the busy time per iteration and the
busy share of the traced window; the kernels are then ranked by their
summed time per iteration.  Prints a few lines per workload and one JSON
line at the end (also written to ``--out``).  The raw traces go to
``<repo>/.traces`` and are deleted after reduction; they are too large to
keep.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
TRACE_DIR = os.path.join(REPO, ".traces")   # listed in .gitignore


def reduce_trace(path, device_prefix, n_iter, top=12):
    """Reduce a perfetto JSON trace to the busy time and kernel ranking of
    the process whose name starts with ``device_prefix``."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    pids = {e["pid"] for e in events
            if e.get("ph") == "M" and e.get("name") == "process_name"
            and str(e.get("args", {}).get("name", "")).startswith(
                device_prefix)}
    if not pids:
        names = sorted({str(e.get("args", {}).get("name")) for e in events
                        if e.get("name") == "process_name"})
        raise RuntimeError(f"no {device_prefix!r} process in the trace: "
                           f"{names}")
    # kernels run on the device's "Stream #..." lines; derived lines (XLA
    # modules / ops) span whole programs, gaps included, so they are left
    # out wherever stream lines exist
    threads = {(e["pid"], e.get("tid")): str(e.get("args", {}).get("name"))
               for e in events
               if e.get("ph") == "M" and e.get("name") == "thread_name"
               and e.get("pid") in pids}
    streams = {k for k, v in threads.items() if v.startswith("Stream")}
    spans = []
    per_name = defaultdict(float)
    count = defaultdict(int)
    for e in events:
        if e.get("ph") != "X" or e.get("pid") not in pids:
            continue
        if streams and (e["pid"], e.get("tid")) not in streams:
            continue
        t0, dur = float(e["ts"]), float(e.get("dur", 0.0))
        spans.append((t0, t0 + dur))
        per_name[e["name"]] += dur
        count[e["name"]] += 1
    if not spans:
        raise RuntimeError("the device ran no kernel in the traced window")
    spans.sort()
    busy, cur0, cur1 = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur1:
            busy += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    busy += cur1 - cur0
    window = spans[-1][1] - spans[0][0]
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
    total = sum(per_name.values())
    return {
        "lines": sorted({threads.get(k, str(k)) for k in streams}),
        "busy_ms_per_it": busy / 1e3 / n_iter,
        "busy_share_of_window": busy / window if window > 0 else 1.0,
        "kernels": [{"name": k, "ms_per_it": v / 1e3 / n_iter,
                     "share": v / total, "calls_per_it": count[k] / n_iter}
                    for k, v in ranked],
    }


def traced(fn, n_iter, device_prefix):
    """Warm ``fn`` (compile), then trace one call; returns the wall time of
    the traced call and the reduced trace."""
    import jax

    jax.block_until_ready(fn())
    os.makedirs(TRACE_DIR, exist_ok=True)
    log_dir = tempfile.mkdtemp(prefix="trace_steps_", dir=TRACE_DIR)
    try:
        with jax.profiler.trace(log_dir, create_perfetto_trace=True):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            wall = time.perf_counter() - t0
        files = glob.glob(os.path.join(log_dir, "**", "perfetto_trace.json*"),
                          recursive=True)
        if not files:
            raise RuntimeError(f"no perfetto trace under {log_dir}")
        out = reduce_trace(files[0], device_prefix, n_iter)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    out["wall_ms_per_it"] = wall * 1e3 / n_iter
    return out


def workloads(n_iter, shape=(32, 8, 256, 256), ct_shape=(16, 4, 512, 512),
              n_angles=96):
    import jax
    import jax.numpy as jnp

    from pytv4d_tpu.core.config import TVConfig
    from pytv4d_tpu.solvers.cp import chambolle_pock
    from pytv4d_tpu.solvers.tgv import tgv_denoise

    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    x0 = jax.random.uniform(jax.random.key(0), shape, jnp.float32) * 100

    def ct():
        from pytv4d_tpu.models.ct import (
            cp_reconstruct,
            estimate_op_norm,
            make_projector,
        )
        from pytv4d_tpu.utils import blob_phantom

        truth = jnp.asarray(blob_phantom(ct_shape))
        angles = np.linspace(0.0, np.pi, n_angles, endpoint=False)
        A, A_T = make_projector(ct_shape, angles, method="spectral")
        sino = jax.jit(A)(truth)
        op_norm = float(estimate_op_norm(A, A_T, ct_shape))
        return lambda: cp_reconstruct(
            sino, angles, ct_shape, n_iter=n_iter, reg=0.05, cfg=cfg,
            op_norm=op_norm, method="spectral").x

    return {
        "cp_f32": lambda: (lambda: chambolle_pock(
            x0, n_iter=n_iter, reg=5.0, cfg=cfg).x),
        "cp_bf16dual": lambda: (lambda: chambolle_pock(
            x0, n_iter=n_iter, reg=5.0, cfg=cfg, dual_dtype="bfloat16").x),
        "tgv4d": lambda: (lambda: tgv_denoise(
            x0, n_iter=n_iter, alpha1=0.1, alpha0=0.2, axes="4d",
            compute_loss=False).x),
        "ct_parallel": ct,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-iter", type=int, default=10)
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", nargs="*", default=None,
                    help="workload names to run (default: all)")
    args = ap.parse_args(argv)

    from pytv4d_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU; JAX found {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    result = {"card": card, "device_kind": dev.device_kind,
              "n_iter": args.n_iter}
    for name, make in workloads(args.n_iter).items():
        if args.only and name not in args.only:
            continue
        r = traced(make(), args.n_iter, f"/device:GPU:{dev.id}")
        result[name] = r
        print(f"[{name}] wall {r['wall_ms_per_it']:.4f} ms/it, device busy "
              f"{r['busy_ms_per_it']:.4f} ms/it "
              f"({100 * r['busy_share_of_window']:.1f} % of the window)",
              flush=True)
        for k in r["kernels"]:
            print(f"[{name}]   {k['ms_per_it']:.4f} ms/it "
                  f"{100 * k['share']:5.1f} %  x{k['calls_per_it']:g}  "
                  f"{k['name'][:90]}", flush=True)
    text = json.dumps(result)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
