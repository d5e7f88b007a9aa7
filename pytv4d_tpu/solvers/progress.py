"""Host progress reporting from device-resident solver scans.

The reference's user loops print loss per iteration for free because they
run on the host (``README.md:119-123``); a ``lax.scan`` under jit gives the
loss back only at the end.  ``emit_progress`` restores the live view as an
opt-in: a ``jax.debug.callback`` gated by ``i % k == 0`` inside the scan
body — the callback rides the device->host stream, compiles away entirely
when ``progress_every=0``, and does not force a pipeline sync (callbacks
are unordered and may print slightly out of step with the device).
"""

from __future__ import annotations

import sys

import jax


def default_progress(i, loss):
    print(f"[pytv4d_tpu] iter {int(i):>6d}  loss {float(loss):.8g}",
          file=sys.stderr, flush=True)


def emit_progress(i, loss, progress_every: int, progress_fn=None):
    """Call inside a scan body with the iteration index and loss scalar."""
    if not progress_every:
        return
    fn = progress_fn or default_progress
    jax.lax.cond(
        i % progress_every == 0,
        lambda: jax.debug.callback(fn, i, loss),
        lambda: None,
    )
