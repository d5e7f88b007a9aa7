"""``chip_smoke.py`` rehearsed on the CPU: every phase at a tiny size (the
four-device phase on the virtual CPU mesh), the refusal to run without a
GPU, a failing phase, and the exact form of the last stdout line."""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

TINY = {
    "phase_tv": dict(shape=(4, 2, 10, 10)),
    "phase_denoise": dict(size=32, n_iter=20),
    "phase_cp4d": dict(shape=(2, 2, 16, 16), n_iter=10),
    "phase_north_star": dict(shape=(4, 2, 16, 16), n_iter=3),
    "phase_tgv": dict(shape=(4, 2, 16, 16), n_iter=5, small=(2, 2, 8, 8)),
    "phase_ct_parallel": dict(vol_shape=(2, 2, 32, 32), n_angles=12,
                              n_iter=5),
    "phase_ct_cone": dict(vol_shape=(8, 2, 32, 32), n_angles=32, n_iter=30,
                          small=(8, 1, 16, 16)),
}


class _FakeDevice:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def no_cache(monkeypatch):
    """main() turns on the persistent compile cache; keep it off here."""
    import pytv4d_tpu.utils

    monkeypatch.setattr(pytv4d_tpu.utils, "enable_compile_cache",
                        lambda *a, **k: None)


@pytest.mark.parametrize("phase", sorted(TINY))
def test_phase_tiny(phase, capsys):
    getattr(chip_smoke, phase)(**TINY[phase])
    out = capsys.readouterr().out
    assert " ok" in out and "FAIL" not in out


def test_phase_four_on_virtual_devices(capsys):
    chip_smoke.phase_four(shape=(8, 4, 16, 16), n_iter=5,
                          ct_shape=(4, 2, 32, 32), n_angles=12, ct_iter=5)
    out = capsys.readouterr().out
    assert "cp shard_map z4 t1" in out and "cp shard_map z2 t2" in out
    assert "ct recon z4 sharded" in out and "FAIL" not in out


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_refuses_without_gpu(argv, capsys, no_cache):
    assert chip_smoke.main(argv) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "needs a GPU" in captured.err


def test_failing_phase_fails_the_run(monkeypatch, capsys, no_cache):
    import jax

    def bad_phase():
        chip_smoke.line("broken", "1", 0.0, 0.0, 1.0, 1e-6)

    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice()])
    monkeypatch.setattr(chip_smoke, "card_record", lambda: "card, 700 W")
    monkeypatch.setattr(chip_smoke, "SINGLE_PHASES", (bad_phase,))
    with pytest.raises(chip_smoke.PhaseFailed, match="broken"):
        chip_smoke.main([])
    out = capsys.readouterr().out
    assert "FAIL" in out and '"ok"' not in out


@pytest.mark.parametrize("argv,count", [([], 1), (["--four"], 4)])
def test_last_line_format(argv, count, monkeypatch, capsys, no_cache):
    import jax

    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice()] * count)
    monkeypatch.setattr(chip_smoke, "card_record",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(chip_smoke, "SINGLE_PHASES", ())
    monkeypatch.setattr(chip_smoke, "phase_four", lambda: None)
    assert chip_smoke.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert lines[-1] == json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}})
    assert json.loads(lines[-1])["device"]["count"] == count


def test_four_needs_four_devices(monkeypatch, capsys, no_cache):
    import jax

    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice()])
    assert chip_smoke.main(["--four"]) != 0
    assert capsys.readouterr().out == ""
