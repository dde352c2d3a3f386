"""Test configuration: run on the CPU with 8 virtual devices.

The 8-device virtual CPU mesh exercises the multi-device sharding paths
without hardware; the fused kernel runs in Pallas' interpret mode. Tests
that need a GPU carry the `gpu` marker and skip here; on a machine with a
card they run with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu

(JAX_PLATFORMS, when set, names the platforms; the default is the CPU).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", False)


# ---- suite split by cost ----------------------------------------------
# Two tiers:
#   python -m pytest tests/ -m "not slow" -q     (fast set)
#   python -m pytest tests/ -m slow -q           (render-heavy + parity)
# Fast tier = unit/oracle math tests and cheap integration only.  Measured
# per-module on a 1-core CPU box (2026-08-20, round 3): the fast set totals
# ~3 min (largest members: test_scene_io 23s,
# test_temporal 22s); any render-loop-heavy module (60-300s each, mostly
# XLA:CPU compile) is tiered slow.  Modules listed here are marked slow
# wholesale; everything else is fast.
# Prefer running the slow set ONE MODULE PER PROCESS (for m in ...; do
# pytest tests/$m.py; done): hour-long single-process runs have hit a
# flaky XLA:CPU compiler segfault that a fresh process avoids, and
# per-module runs isolate any such crash to one module's report.

import pytest  # noqa: E402

SLOW_MODULES = {
    # interpreter-mode Pallas parity suites (the original slow tier)
    "test_reference_oracle",
    "test_mega_pallas",
    "test_sharding_pallas",
    "test_photon_strata",
    "test_golden",
    "test_hero_wavelengths",
    "test_wavefront",
    # render-heavy extension suites (measured 60-300s each on 1 core —
    # dominated by per-config XLA:CPU compiles, so shape shrinking does
    # not recover them; VERDICT r2 item 4)
    "test_adaptive",        # 196s
    "test_qmc",             # 302s
    "test_light_sample",    # 154s
    "test_denoise",         #  68s
    "test_motion",          #  69s
    "test_emissive",        # 185s
    "test_sky",             # 173s
    "test_clamp",           #  94s
    "test_dof",             #  60s
    "test_photon_aim",      #  79s
    "test_photon_rr",       #  94s
    "test_presets_until",   #  97s
    "test_api_doc",         #  94s
    "test_geometry_shard",  # 8-dev-mesh renders (geometry sharding)
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: interpreter-heavy Pallas parity suites")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (the `gpu` fixture skips "
        "without one)")


@pytest.fixture
def gpu():
    """The first device, if it is a GPU; skip the test otherwise. Decided
    when the test runs, never at import or collection."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform!r} here")
    return dev


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.module.__name__.rsplit(".", 1)[-1] in SLOW_MODULES:
            item.add_marker(pytest.mark.slow)
