"""Test env: force the CPU backend with 8 virtual devices (so the sharded
halo-exchange paths are testable without several GPUs — SURVEY.md section 4)
and enable x64 so the numpy and jax paths agree to f64 precision.

Must run before jax is imported anywhere.  The ``gpu`` marker is
registered for card-only tests; none exist yet.
"""

import os

# The suite is defined to run on the virtual CPU mesh unless the caller
# explicitly asks for another backend.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_ENABLE_X64", "1")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Installed pytest plugins (jaxtyping) import jax before this conftest runs,
# baking the ambient env into jax.config — override the config directly too
# (safe: the backend itself is only initialized on first device use).
import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)


# ---------------------------------------------------------------------------
# Quick/full test tiers (the default run must stay under
# 4 minutes without any oracle family losing coverage).
#
# Tiering is DATA-DRIVEN: tests/durations.json records per-test runtimes
# (regenerate with tools/make_durations.py after a `--full --durations=0`
# run); tests at or above _FULL_THRESHOLD_S are deferred to the full tier
# unless kept by _ALWAYS_QUICK.  Tests missing from the manifest (new tests,
# renames) default to QUICK, so the manifest can lag the suite safely.
#
#   quick (default):  python -m pytest tests/ -q          (~3 min)
#   full  (CI of record):  python -m pytest tests/ -q --full   (~17 min)
# ---------------------------------------------------------------------------

import json

import pytest

_FULL_THRESHOLD_S = 1.5

# one representative per oracle family stays in the quick tier regardless
# of cost: golden reference parity, CT projector adjointness, adjointness
# under sharding, spectral-projector analytic accuracy
_ALWAYS_QUICK = {
    "tests/test_golden.py::test_readme_headline_values",
    "tests/test_ct.py::test_projector_adjointness",
    "tests/test_sharding.py::test_sharded_adjointness[hybrid]",
    "tests/test_ct_spectral.py::test_spectral_matches_analytic_gaussians",
}


def pytest_addoption(parser):
    parser.addoption(
        "--full", action="store_true", default=False,
        help="run the full battery including tests deferred from the "
             "quick tier (recorded runtime >= %.1fs or @pytest.mark.full)"
        % _FULL_THRESHOLD_S,
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "full: deferred to the full battery (pytest --full); assigned "
        "automatically from tests/durations.json or explicitly",
    )
    config.addinivalue_line(
        "markers",
        "slow: expensive test (multi-process bootstrap etc.); "
        "informational — tiering itself is handled by the full marker",
    )
    config.addinivalue_line(
        "markers",
        "gpu: runs only on a GPU; such a test decides to skip inside a "
        "fixture at run time, never at import or collection",
    )


def _recorded_durations():
    path = os.path.join(os.path.dirname(__file__), "durations.json")
    try:
        with open(path) as f:
            return json.load(f)
    except OSError:
        return {}


def pytest_collection_modifyitems(config, items):
    durations = _recorded_durations()
    skip_quick = pytest.mark.skip(
        reason="full tier (recorded runtime >= %.1fs) — run with --full"
        % _FULL_THRESHOLD_S
    )
    for item in items:
        nodeid = item.nodeid.replace("\\", "/")
        heavy = durations.get(nodeid, 0.0) >= _FULL_THRESHOLD_S
        if heavy and nodeid not in _ALWAYS_QUICK:
            item.add_marker(pytest.mark.full)
        if config.getoption("--full"):
            continue
        if item.get_closest_marker("full") is not None:
            item.add_marker(skip_quick)
