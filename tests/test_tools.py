"""The trace reducer of ``tools/trace_steps.py`` on synthetic perfetto
traces, and the blob phantom the cone-beam checks score against."""

import gzip
import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import trace_steps  # noqa: E402

from pytv4d_tpu.utils import blob_phantom  # noqa: E402


def _meta(kind, pid, name, tid=None):
    e = {"ph": "M", "name": kind, "pid": pid, "args": {"name": name}}
    if tid is not None:
        e["tid"] = tid
    return e


def _x(pid, tid, name, ts, dur):
    return {"ph": "X", "pid": pid, "tid": tid, "name": name, "ts": ts,
            "dur": dur}


def _write(tmp_path, events, gz):
    path = tmp_path / ("t.json.gz" if gz else "t.json")
    data = json.dumps({"traceEvents": events})
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(data)
    else:
        path.write_text(data)
    return str(path)


@pytest.mark.parametrize("gz", [False, True])
def test_reduce_trace_merges_streams(tmp_path, gz):
    """Busy time is the union of the stream lines' kernel intervals
    (overlaps across streams count once), the window runs from the first
    kernel's start to the last one's end, derived lines and other
    processes are left out, and kernels rank by summed time."""
    events = [
        _meta("process_name", 1, "/device:GPU:0"),
        _meta("thread_name", 1, "Stream #13(Compute)", tid=13),
        _meta("thread_name", 1, "Stream #14(MemcpyD2D)", tid=14),
        _meta("thread_name", 1, "XLA Modules", tid=99),
        _meta("process_name", 2, "/host:CPU"),
        _x(1, 13, "fusion_a", 0.0, 400.0),
        _x(1, 14, "memcpy", 300.0, 200.0),      # overlaps fusion_a by 100
        _x(1, 13, "fusion_b", 700.0, 300.0),    # gap 500..700
        _x(1, 13, "fusion_a", 1000.0, 200.0),
        _x(1, 99, "jit_module", 0.0, 1200.0),   # derived line: ignored
        _x(2, 1, "python", 0.0, 5000.0),        # host: ignored
    ]
    r = trace_steps.reduce_trace(_write(tmp_path, events, gz),
                                 "/device:GPU:0", n_iter=2)
    assert r["lines"] == ["Stream #13(Compute)", "Stream #14(MemcpyD2D)"]
    busy_us = 500.0 + 500.0          # [0, 500) and [700, 1200)
    assert r["busy_ms_per_it"] == pytest.approx(busy_us / 1e3 / 2)
    assert r["busy_share_of_window"] == pytest.approx(busy_us / 1200.0)
    names = [k["name"] for k in r["kernels"]]
    assert names == ["fusion_a", "fusion_b", "memcpy"]
    top = r["kernels"][0]
    assert top["ms_per_it"] == pytest.approx(0.3)
    assert top["calls_per_it"] == 1.0
    assert top["share"] == pytest.approx(600.0 / 1100.0)


def test_reduce_trace_names_missing_device(tmp_path):
    events = [_meta("process_name", 2, "/host:CPU"),
              _x(2, 1, "python", 0.0, 10.0)]
    with pytest.raises(RuntimeError, match="/host:CPU"):
        trace_steps.reduce_trace(_write(tmp_path, events, False),
                                 "/device:GPU:0", n_iter=1)


def test_reduce_trace_refuses_an_idle_device(tmp_path):
    events = [_meta("process_name", 1, "/device:GPU:0"),
              _meta("thread_name", 1, "Stream #13(Compute)", tid=13)]
    with pytest.raises(RuntimeError, match="no kernel"):
        trace_steps.reduce_trace(_write(tmp_path, events, False),
                                 "/device:GPU:0", n_iter=1)


@pytest.mark.parametrize("vol_shape", [(16, 4, 64, 64), (2, 1, 32, 32)])
def test_blob_phantom_lies_inside_the_field_of_view(vol_shape):
    """Blobs sit in the middle half of the plane and away from the slab's
    end slices, so a cone beam's detector sees all of each projection;
    frame m is frame 0 scaled by 1 - 0.1 m; the seed fixes the volume."""
    Nz, M, N, _ = vol_shape
    v = blob_phantom(vol_shape)
    assert v.shape == vol_shape and v.dtype == np.float32
    assert np.all(v >= 0) and v.max() > 0.5
    for m in range(M):
        np.testing.assert_allclose(v[:, m], v[:, 0] * (1 - 0.1 * m),
                                   rtol=1e-6)
    edge = max(v[:, 0, :, :2].max(), v[:, 0, :, -2:].max(),
               v[:, 0, :2].max(), v[:, 0, -2:].max())
    assert edge < 0.05 * v.max()
    if Nz >= 6:
        assert max(v[0].max(), v[-1].max()) < 0.5 * v.max()
    np.testing.assert_array_equal(v, blob_phantom(vol_shape))
    assert not np.array_equal(v, blob_phantom(vol_shape, seed=1))
