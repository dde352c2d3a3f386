"""The regenerative megakernel (tpurt/kernels/mega_regen.py): against the
XLA integrator in Pallas' interpret mode, through the Triton lowering it
is compiled with on the GPU, and its dispatch rules. The GPU-compiled
kernel itself is checked by the `gpu` test at the end (skips without a
card) and by chip_smoke.py."""

import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpurt import (RenderConfig, cornell_spheres_scene, dispersive_scene,
                   init_state, instanced_scene, make_camera, render,
                   resolve_image, torus_mesh_scene)
from tpurt import runtime
from tpurt.kernels import mega_regen
from tpurt.kernels.mega_pallas import freeze_scene

ROOT = pathlib.Path(__file__).resolve().parent.parent
CAM = make_camera((0.0, 5.0, -12.0), (0.0, 5.0, 0.0), vfov=60.0,
                  aspect_ratio=2.0)


def _cfg(**kw):
    return RenderConfig(**{**dict(width=32, height=16, depth=3, k_photons=2,
                                  max_photon_bounces=2, tile_size=512),
                           **kw})


def _pair(scene, spp=2, **kw):
    st_x = render(scene, _cfg(backend="xla", **kw), CAM,
                  init_state(_cfg(backend="xla", **kw)), 1234, spp)
    cfg_k = _cfg(backend="pallas", **kw)
    st_k = render(scene, cfg_k, CAM, init_state(cfg_k), 1234, spp)
    return st_x, st_k, cfg_k


def test_interpreted_kernel_matches_xla_exact_segments():
    st_x, st_k, cfg = _pair(cornell_spheres_scene())
    assert float(st_k.rays) == float(st_x.rays) > 0.0
    n = cfg.n_pixels
    d = np.abs(np.asarray(st_k.rgb_sum)[:n] - np.asarray(st_x.rgb_sum)[:n])
    # reassociation can flip rare near-threshold branches
    assert np.median(d) < 1e-4
    assert (d.max(axis=-1) > 1e-2).mean() < 0.05
    np.testing.assert_allclose(float(st_k.photon_radius),
                               float(st_x.photon_radius), rtol=1e-6)
    assert np.isfinite(np.asarray(resolve_image(cfg, st_k))).all()


def _lower_for_gpu(scene, cfg):
    """Trace the kernel's jit with interpret=False and lower it for CUDA:
    runs the Pallas -> Triton lowering here, without a card."""
    st = init_state(cfg)
    return mega_regen._render_regen_jit.trace(
        freeze_scene(scene), cfg, CAM, st, jnp.uint32(1), jnp.int32(2),
        False, depth=jnp.int32(cfg.depth)).lower(
            lowering_platforms=("cuda",))


@pytest.mark.parametrize("case", [
    "cornell", "dispersive_hero", "cull_tree", "sphere_table",
    "triangle_table"])
def test_kernel_lowers_to_triton(case):
    scene, kw = {
        "cornell": (cornell_spheres_scene(), {}),
        "dispersive_hero": (dispersive_scene(), dict(
            hero_wavelengths=4, dispersion_in_camera_path=True)),
        "cull_tree": (instanced_scene(40), dict(
            pallas_static_unroll=64, pallas_cluster_size=8,
            pallas_regen_drift=1, photon_strata=4)),
        "sphere_table": (instanced_scene(40), dict(pallas_static_unroll=8)),
        "triangle_table": (torus_mesh_scene(8, 4), dict(
            pallas_static_unroll=8)),
    }[case]
    text = _lower_for_gpu(scene, _cfg(backend="pallas", **kw)).as_text()
    assert "__gpu$xla.gpu.triton" in text


@pytest.mark.parametrize("lanes,warps", [(128, 8), (512, 32)])
def test_kernel_runs_two_threads_per_lane(lanes, warps):
    text = _lower_for_gpu(cornell_spheres_scene(),
                          _cfg(backend="pallas", pallas_lanes=lanes)).as_text()
    assert f"num_warps = {warps} : i32" in text


def test_compiled_kernel_refuses_more_than_32_warps():
    cfg = _cfg(backend="pallas", pallas_lanes=1024)
    with pytest.raises(ValueError, match="pallas_lanes <= 512"):
        _lower_for_gpu(cornell_spheres_scene(), cfg)


def test_pallas_backend_raises_on_unsupported_scene():
    scene = torus_mesh_scene(20, 20)  # 800 triangles > the table bound
    cfg = _cfg(backend="pallas")
    with pytest.raises(ValueError, match="backend='xla'"):
        render(scene, cfg, CAM, init_state(cfg), 1, 1)


def test_pallas_lanes_must_be_power_of_two_rows():
    cfg = _cfg(backend="pallas", pallas_lanes=384)
    with pytest.raises(ValueError, match="pallas_lanes"):
        render(cornell_spheres_scene(), cfg, CAM, init_state(cfg), 1, 1)


def test_interpret_helper_by_platform(monkeypatch):
    assert runtime.pallas_interpret("gpu") is False
    assert runtime.pallas_interpret("cpu") is True
    monkeypatch.setattr(runtime.jax, "devices", lambda: [
        types.SimpleNamespace(platform="metal", device_kind="x")])
    with pytest.raises(RuntimeError, match="backend='xla'"):
        runtime.pallas_interpret()


def test_compile_cache_dir(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert runtime.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == old  # untouched
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        path = runtime.enable_compile_cache()
        assert path == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert ".jax_cache/" in (ROOT / ".gitignore").read_text()
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_no_tpu_kernel_code_left():
    """No module, tool or entry script imports the TPU Pallas dialect or
    picks interpret mode by comparing against the TPU backend."""
    files = [*ROOT.glob("tpurt/**/*.py"), *ROOT.glob("tools/*.py"),
             *ROOT.glob("*.py")]
    assert len(files) > 30
    banned = ("pallas.tpu", "pltpu", 'default_backend() != "tpu"')
    for f in files:
        text = f.read_text()
        for b in banned:
            assert b not in text, f"{f.relative_to(ROOT)} contains {b!r}"


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu(gpu):
    st_x, st_k, cfg = _pair(cornell_spheres_scene(), spp=4)
    assert float(st_k.rays) == float(st_x.rays) > 0.0
    n = cfg.n_pixels
    d = np.abs(np.asarray(st_k.rgb_sum)[:n] - np.asarray(st_x.rgb_sum)[:n])
    assert np.median(d) < 1e-4
