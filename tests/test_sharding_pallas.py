"""Multi-chip Pallas megakernel: pixel-slab sharding must be invisible.

tile_base offsets keep pixel ids (and therefore PCG streams) global, so an
8-device sharded run must produce the same planes as one device running the
whole frame — up to float reassociation in the per-tile ray-count sums.
Runs on the 8-device virtual CPU mesh (kernel via the Pallas interpreter).
"""

import jax.numpy as jnp
import numpy as np

from tpurt import RenderConfig, cornell_spheres_scene, make_camera
from tpurt.kernels import mega_pallas as mp
from tpurt.parallel import sharding as sh


import pytest


@pytest.mark.parametrize("drift", [0, 4])
def test_sharded_regen_bit_identical(drift):
    """The sharded regenerative kernel equals single-chip bit-for-bit
    (tile_base keeps all streams global; per-lane schedules identical).
    Runs on the FULL 8-device mesh: 64x32 px at 256 lanes/tile = 16 tiles,
    2 per device (VERDICT r1 weak-item 3). drift=4 additionally pins that
    the bounded-drift schedule (a tile-LOCAL min) changes nothing under
    shard_map either."""
    from tpurt.render import init_state, render
    cfg = RenderConfig(width=64, height=32, depth=3, backend="pallas",
                       pallas_lanes=256, k_photons=1, max_photon_bounces=2,
                       pallas_regen_drift=drift)
    scene = cornell_spheres_scene()
    cam = make_camera((0.0, 5.0, -12.0), (0.0, 5.0, 0.0), vfov=60.0,
                      aspect_ratio=2.0)
    mesh = sh.make_mesh(8)
    planes = sh.init_planes_sharded(cfg, mesh)
    step = sh.make_regen_sharded_step(mesh, cfg, scene, spp=2)
    planes, it, radius, rays = step(
        cam, planes, jnp.int32(0), jnp.float32(cfg.photon_radius_init),
        jnp.float32(0.0), jnp.uint32(11))
    st = render(scene, cfg, cam, init_state(cfg), 11, 2)
    assert float(rays) == float(st.rays)
    flat = np.asarray(planes).reshape(16, -1)
    flat = np.asarray(mp.planes_pixel_order(cfg, jnp.asarray(flat)))
    a = np.stack([flat[0], flat[1], flat[2]], -1)
    np.testing.assert_array_equal(a, np.asarray(st.rgb_sum))


def test_sharded_regen_power_light_bit_identical():
    """cfg.light_sample="power" under shard_map equals single-chip
    bit-for-bit on a 4-light scene (the select uniform rides the same
    global per-pixel stream on every device)."""
    from tpurt import many_light_scene
    from tpurt.render import init_state, render
    cfg = RenderConfig(width=64, height=32, depth=3, backend="pallas",
                       pallas_lanes=256, k_photons=1, max_photon_bounces=2,
                       light_sample="power")
    scene = many_light_scene(4)
    cam = make_camera((0.0, 5.0, -12.0), (0.0, 5.0, 0.0), vfov=60.0,
                      aspect_ratio=2.0)
    mesh = sh.make_mesh(8)
    planes = sh.init_planes_sharded(cfg, mesh)
    step = sh.make_regen_sharded_step(mesh, cfg, scene, spp=2)
    planes, it, radius, rays = step(
        cam, planes, jnp.int32(0), jnp.float32(cfg.photon_radius_init),
        jnp.float32(0.0), jnp.uint32(23))
    st = render(scene, cfg, cam, init_state(cfg), 23, 2)
    assert float(rays) == float(st.rays)
    flat = np.asarray(planes).reshape(16, -1)
    flat = np.asarray(mp.planes_pixel_order(cfg, jnp.asarray(flat)))
    a = np.stack([flat[0], flat[1], flat[2]], -1)
    np.testing.assert_array_equal(a, np.asarray(st.rgb_sum))


def test_regen_sample_sharded_matches_sequential_blocks():
    """SAMPLE sharding on the regenerative kernel: 8 devices each advancing
    one sample of the global sequence == the same per-block regen_call runs
    combined by hand (delta-sum radiance channels, last block's vispoints).
    Schedule (radius_after) is the exact sequential float sequence."""
    from tpurt.kernels import mega_regen as mr
    from tpurt.render import padded_pixels

    cfg = RenderConfig(width=64, height=32, depth=3, backend="pallas",
                       pallas_lanes=256, k_photons=1, max_photon_bounces=2)
    scene = cornell_spheres_scene()
    cam = make_camera((0.0, 5.0, -12.0), (0.0, 5.0, 0.0), vfov=60.0,
                      aspect_ratio=2.0)
    TR = padded_pixels(cfg) // 128
    planes0 = jnp.zeros((mp.N_CHANNELS, TR, 128), jnp.float32)
    r0 = jnp.float32(cfg.photon_radius_init)

    mesh = sh.make_mesh(8)
    step = sh.make_regen_sample_sharded_step(mesh, cfg, scene, spp=8)
    planes, it, radius, rays = step(cam, planes0, jnp.int32(0), r0,
                                    jnp.float32(0.0), jnp.uint32(11))
    assert int(it) == 8

    fscene = mr.freeze_scene(scene)
    deltas, vis_last, rays_sum = [], None, 0.0
    for d in range(8):
        r_d = mr.radius_after(cfg, jnp.int32(0), r0, jnp.int32(d))
        npl, tr = mr.regen_call(fscene, cfg, cam, planes0, jnp.uint32(11),
                                jnp.int32(1), jnp.int32(d), r_d,
                                jnp.int32(0), True)
        deltas.append(np.asarray(npl[:3]) - np.asarray(planes0[:3]))
        vis_last = np.asarray(npl[3:])
        rays_sum += float(jnp.sum(tr))

    rgb_ref = np.asarray(planes0[:3]) + np.sum(deltas, axis=0)
    np.testing.assert_allclose(np.asarray(planes[:3]), rgb_ref,
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(planes[3:]), vis_last)
    np.testing.assert_allclose(float(rays), rays_sum, rtol=1e-6)
    assert rays_sum > 0
    r_ref = mr.radius_after(cfg, jnp.int32(0), r0, jnp.int32(8))
    assert float(radius) == float(r_ref)

    img = sh.resolve_planes(cfg, planes, int(it))
    assert img.shape == (32, 64, 3) and np.isfinite(img).all()


def test_render_image_sharded_front_door():
    """The one-call multi-chip facade dispatches every axis/kernel pair and
    returns a finite image of the right shape."""
    import pytest

    cam = make_camera((0.0, 5.0, -12.0), (0.0, 5.0, 0.0), vfov=60.0,
                      aspect_ratio=2.0)
    scene = cornell_spheres_scene()
    mesh = sh.make_mesh(8)

    # XLA, pixel axis (explicit)
    cfg = RenderConfig(width=64, height=32, depth=2, backend="xla",
                       tile_size=256)
    img, info = sh.render_image_sharded(scene, cfg, cam, spp=2, mesh=mesh,
                                        axis="pixel")
    assert img.shape == (32, 64, 3) and np.isfinite(img).all()
    assert info["kernel"] == "xla/pixel" and info["rays"] > 0

    # XLA, auto -> sample axis on a tiny image (2048 px / 8 dev < 4096)
    img2, info2 = sh.render_image_sharded(scene, cfg, cam, spp=8, mesh=mesh)
    assert info2["axis"] == "sample" and info2["kernel"] == "xla/sample"
    assert img2.shape == (32, 64, 3) and np.isfinite(img2).all()

    # regenerative megakernel, pixel axis
    pcfg = RenderConfig(width=64, height=32, depth=2, backend="pallas",
                        pallas_lanes=256, k_photons=1, max_photon_bounces=2)
    img3, info3 = sh.render_image_sharded(scene, pcfg, cam, spp=1, mesh=mesh,
                                          axis="pixel")
    assert info3["kernel"] == "regen/pixel" and info3["rays"] > 0
    assert img3.shape == (32, 64, 3) and np.isfinite(img3).all()

    # wavefront pool, one per device
    wcfg = RenderConfig(width=64, height=32, depth=2, backend="wavefront",
                        wf_pool=256, enable_photons=False, tile_size=256)
    img4, info4 = sh.render_image_sharded(scene, wcfg, cam, spp=2, mesh=mesh)
    assert info4["kernel"] == "wavefront" and info4["rays"] > 0
    assert img4.shape == (32, 64, 3) and np.isfinite(img4).all()

    # a scene beyond the fused kernel's scope raises, naming backend='xla'
    from tpurt import torus_mesh_scene
    with pytest.raises(ValueError, match="backend='xla'"):
        sh.render_image_sharded(torus_mesh_scene(20, 20), pcfg, cam, spp=1,
                                mesh=mesh, axis="pixel")


def test_sharded_regen_budget_bit_identical():
    """The sharded BUDGET regen step (adaptive sampling, full estimator)
    equals the single-chip render_budget_regen bit-for-bit across the full
    8-device mesh: aux budget/count/radius planes shard like the state."""
    from tpurt.kernels.mega_regen import render_budget_regen
    from tpurt.render import init_state, padded_pixels
    cfg = RenderConfig(width=64, height=32, depth=3, backend="pallas",
                       pallas_lanes=256, k_photons=1, max_photon_bounces=2)
    scene = cornell_spheres_scene()
    cam = make_camera((0.0, 5.0, -12.0), (0.0, 5.0, 0.0), vfov=60.0,
                      aspect_ratio=2.0)
    P = padded_pixels(cfg)
    rng = np.random.default_rng(6)
    budgets = np.zeros((P,), np.int32)
    budgets[: cfg.n_pixels] = rng.integers(0, 4, cfg.n_pixels)
    budgets = jnp.asarray(budgets)

    st0 = init_state(cfg)
    st_single = render_budget_regen(scene, cfg, cam, st0, 17, budgets, 3)

    mesh = sh.make_mesh(8)
    planes = sh.init_planes_sharded(cfg, mesh)
    aux, clipped = sh.build_regen_budget_aux(cfg, budgets, st0.n_samples, 3)
    step = sh.make_regen_budget_sharded_step(mesh, cfg, scene)
    planes, rays = step(cam, planes, aux, jnp.float32(0.0), jnp.uint32(17))

    assert float(rays) == float(st_single.rays) != 0.0
    flat = np.asarray(planes).reshape(16, -1)
    flat = np.asarray(mp.planes_pixel_order(cfg, jnp.asarray(flat)))
    a = np.stack([flat[0], flat[1], flat[2]], -1)
    np.testing.assert_array_equal(a, np.asarray(st_single.rgb_sum))
