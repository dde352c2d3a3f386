"""chip_smoke.py: its phases at a tiny size on the CPU (the fused kernel
interpreted), the four-device comparison on virtual CPU devices, and its
refusal to report a result without a GPU or without the repository."""

import json
import pathlib
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def test_phases_tiny():
    ref, info = chip_smoke.phase_xla(32, 16, spp=2, depth=3)
    assert info["ok"] and info["segments"] > 0
    assert "CompiledMemoryStats" in info["memory_analysis"]
    _, info = chip_smoke.phase_kernel(ref, 32, 16, spp=2, depth=3)
    assert info["ok"], info["compare"]
    assert info["compare"]["rays_rel"] == 0.0
    info = chip_smoke.phase_golden()
    assert info["ok"], info["observed"]


def test_four_device_steps_match_one_device():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices (the conftest gives 8 virtual CPUs)")
    res = chip_smoke.four_phases(4, 32, 16, spp=4, depth=3, torus=(6, 3))
    assert set(res) == {"xla/pixel", "xla/sample", "regen/pixel",
                        "regen/sample", "xla/geometry",
                        "xla/pixel x geometry"}
    assert all(r["ok"] for r in res.values()), res


def _run(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin",
                               "JAX_PLATFORMS": "cpu"})


def _printed_result(stdout):
    lines = stdout.strip().splitlines()
    try:
        return "ok" in json.loads(lines[-1])
    except (IndexError, ValueError):
        return False


def test_refuses_without_gpu():
    p = _run(ROOT)
    assert p.returncode != 0
    assert not _printed_result(p.stdout)
    assert "needs a GPU" in p.stderr


def test_refuses_without_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    p = _run(tmp_path)
    assert p.returncode != 0
    assert not _printed_result(p.stdout)
