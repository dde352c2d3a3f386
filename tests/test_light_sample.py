"""Many-light NEE: cfg.light_sample = "power" (EXTENSION over the
reference, which loops NEE over every light — wgsl :568-615).

Contract under test:
  * unbiasedness — power mode converges to the same image as "all" mode
    (one power-proportionally selected light weighted by 1/pmf);
  * O(1) shadow segments — exactly ONE shadow segment per diffuse lane
    per bounce, regardless of light count, in the ray counters;
  * cross-backend exactness — all backends consume the same draw layout
    in power mode (1 select uniform + the 2f light sample), so ray
    counters match exactly and images match up to float reassociation.
"""

import numpy as np
import pytest

from tpurt import Light, Material, RenderConfig, Sphere, build_scene, \
    make_camera
from tpurt.render import init_state, render

W, H = 32, 16


def _many_light_scene():
    """Closed diffuse box-ish scene with 4 lights of very unequal power:
    power selection must up-weight the bright area light without biasing
    the dim points away."""
    mats = [Material.diffuse((0.73, 0.73, 0.73)),
            Material.diffuse((0.65, 0.30, 0.30))]
    sph = [Sphere(0, 1000.0, (0.0, -1000.0, 0.0)),   # floor
           Sphere(0, 1000.0, (0.0, 1012.0, 0.0)),    # ceiling
           Sphere(1, 1.5, (0.0, 1.5, 5.0)),
           Sphere(0, 1.0, (-2.5, 1.0, 4.0))]
    lights = [
        Light.square_area([0.0, 9.0, 5.0], [0.0, -1.0, 0.0], 1.5,
                          [1.0, 0.9, 0.8], 20.0, 5500.0),
        Light.point([4.0, 3.0, 2.0], [0.2, 0.4, 1.0], 0.5, 0.0),
        Light.point([-4.0, 2.0, 6.0], [1.0, 0.2, 0.2], 2.0, 0.0),
        Light.square_area([3.0, 7.0, 8.0], [0.0, -1.0, 0.0], 0.5,
                          [0.5, 1.0, 0.5], 1.0, 3000.0),
    ]
    return build_scene(mats, sph, [], lights)


def _cam():
    return make_camera((0.0, 3.0, -6.0), (0.0, 1.5, 5.0), vfov=55.0,
                       aspect_ratio=W / H)


def test_light_select_power_unit():
    """Selection pmf matches the power heuristic; exactly one light per
    lane; inv_pmf is the selected bucket's true 1/pmf."""
    import jax.numpy as jnp
    from tpurt.ops.sampling import light_select_power

    intensities = [np.float32(10.0), np.float32(0.5), np.float32(2.0)]
    hws = [np.float32(1.5), np.float32(0.0), np.float32(0.0)]
    is_areas = [True, False, False]
    powers = np.array([10.0 * 4 * 1.5 * 1.5, 0.5, 2.0], np.float64)
    pmf = powers / powers.sum()

    n = 200_000
    u = (np.arange(n, dtype=np.float64) + 0.5) / n  # uniform grid
    sels, inv_pmf = light_select_power(
        jnp.asarray(u, jnp.float32), intensities, hws, is_areas)
    sels = np.stack([np.asarray(s) for s in sels])
    # exactly one selected per lane, even at u ~ 1
    assert (sels.sum(axis=0) == 1).all()
    freq = sels.mean(axis=1)
    np.testing.assert_allclose(freq, pmf, atol=2e-4)
    # inv_pmf plane holds the selected light's 1/pmf
    got = np.asarray(inv_pmf)
    want = (1.0 / pmf)[sels.argmax(axis=0)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # u at the very top of the range still lands in the last bucket
    top_sels, _ = light_select_power(
        jnp.asarray([np.float32(1.0) - np.float32(6e-8)]),
        intensities, hws, is_areas)
    assert sum(bool(np.asarray(s)[0]) for s in top_sels) == 1


def test_power_unbiased_vs_all():
    """XLA backend: the power and spatial estimators converge to the
    all-lights image (same physics, stochastic light choice weighted by
    1/pmf)."""
    scene = _many_light_scene()
    cam = _cam()
    spp = 96
    means = {}
    for mode in ("all", "power", "spatial"):
        cfg = RenderConfig(width=W, height=H, depth=3, backend="xla",
                           enable_photons=False, light_sample=mode)
        st = render(scene, cfg, cam, init_state(cfg), 321, spp)
        img = np.asarray(st.rgb_sum)[:W * H] / spp
        assert np.isfinite(img).all()
        means[mode] = img.mean(axis=0)
    np.testing.assert_allclose(means["power"], means["all"], rtol=0.06)
    np.testing.assert_allclose(means["spatial"], means["all"], rtol=0.06)


def test_power_one_shadow_segment_per_bounce():
    """Floor scene, depth 1: both modes hit the same D diffuse lanes
    (the camera spawn draws are identical; NEE runs before any
    mode-dependent draw), so rays = N + L*D in all mode and N + D in
    power mode — an exact relation with L=3 lights."""
    mats = [Material.diffuse((0.7, 0.7, 0.7))]
    sph = [Sphere(0, 1000.0, (0.0, -1000.0, 0.0))]   # floor
    lights = [Light.point([0.0, 5.0, 0.0], [1, 1, 1], 5.0, 0.0),
              Light.point([3.0, 2.0, 0.0], [1, 1, 1], 1.0, 0.0),
              Light.square_area([0.0, 6.0, 5.0], [0.0, -1.0, 0.0], 1.0,
                                [1, 1, 1], 2.0, 0.0)]
    scene = build_scene(mats, sph, [], lights)
    cam = make_camera((0.0, 2.0, -5.0), (0.0, -1.0, 5.0), vfov=60.0,
                      aspect_ratio=W / H)
    rays = {}
    for mode in ("all", "power"):
        cfg = RenderConfig(width=W, height=H, depth=1, backend="xla",
                           enable_photons=False, light_sample=mode)
        st = render(scene, cfg, cam, init_state(cfg), 7, 1)
        rays[mode] = float(st.rays)
    n = W * H
    d = rays["power"] - n           # diffuse-hit lanes: 1 shadow seg each
    assert 0 < d <= n
    assert rays["all"] == n + 3 * d, rays


def test_no_lights_counts_no_shadow_segments():
    """Zero-light scene: NEE is gated on L > 0 in every backend, so
    single-light modes must not count the phantom per-lane shadow
    segment — rays must be mode-independent (camera segments only)."""
    mats = [Material.diffuse((0.7, 0.7, 0.7))]
    sph = [Sphere(0, 1000.0, (0.0, -1000.0, 0.0))]   # floor
    scene = build_scene(mats, sph, [], [])
    cam = make_camera((0.0, 2.0, -5.0), (0.0, -1.0, 5.0), vfov=60.0,
                      aspect_ratio=W / H)
    rays = {}
    for mode in ("all", "power", "spatial"):
        cfg = RenderConfig(width=W, height=H, depth=2, backend="xla",
                           enable_photons=False, light_sample=mode)
        st = render(scene, cfg, cam, init_state(cfg), 7, 1)
        rays[mode] = float(st.rays)
    assert rays["power"] == rays["all"] == rays["spatial"], rays
    assert rays["all"] > 0.0


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["power", "spatial"])
def test_power_cross_backend_camera_paths(mode):
    """Same draw layout in every backend: exact ray-counter parity and
    image agreement up to reassociation (camera paths only — the
    wavefront family has no photon pass)."""
    scene = _many_light_scene()
    cam = _cam()
    kw = dict(width=W, height=H, depth=3, enable_photons=False,
              light_sample=mode, tile_size=512, pallas_lanes=512,
              wf_pool=512)
    results = {}
    for name, extra in (
        ("xla", dict(backend="xla")),
        ("pallas", dict(backend="pallas")),
        ("wavefront", dict(backend="wavefront")),
    ):
        cfg = RenderConfig(**kw, **extra)
        st = render(scene, cfg, cam, init_state(cfg), 55, 2)
        results[name] = (float(st.rays), np.asarray(st.rgb_sum)[:W * H])
    rays = {name: r for name, (r, _) in results.items()}
    assert len(set(rays.values())) == 1 and rays["xla"] != 0.0, rays
    ref = results["xla"][1]
    for name, (_, img) in results.items():
        assert np.isfinite(img).all(), name
        assert abs(img.mean() - ref.mean()) < 5e-3 * max(ref.mean(), 1e-3), \
            name
        diverged = np.abs(img - ref).max(axis=-1) > 1e-3
        assert diverged.mean() < 0.02, (name, diverged.mean())


@pytest.mark.slow
def test_power_cross_backend_with_photons():
    """Power-mode NEE + the photon pass (regen restores the photon
    stream after the camera-only NEE draws): xla / pallas agree
    on ray counts exactly."""
    scene = _many_light_scene()
    cam = _cam()
    kw = dict(width=W, height=H, depth=3, light_sample="power",
              tile_size=512, pallas_lanes=512, k_photons=1,
              max_photon_bounces=2)
    results = {}
    for name, extra in (
        ("xla", dict(backend="xla")),
        ("pallas", dict(backend="pallas")),
    ):
        cfg = RenderConfig(**kw, **extra)
        st = render(scene, cfg, cam, init_state(cfg), 99, 2)
        results[name] = (float(st.rays), np.asarray(st.rgb_sum)[:W * H])
    rays = {name: r for name, (r, _) in results.items()}
    assert len(set(rays.values())) == 1 and rays["xla"] != 0.0, rays
    ref = results["xla"][1]
    for name, (_, img) in results.items():
        assert np.isfinite(img).all(), name
        assert abs(img.mean() - ref.mean()) < 5e-3 * max(ref.mean(), 1e-3), \
            name
        diverged = np.abs(img - ref).max(axis=-1) > 1e-3
        assert diverged.mean() < 0.02, (name, diverged.mean())


def test_light_sample_validated():
    scene = _many_light_scene()
    cfg = RenderConfig(width=W, height=H, light_sample="bogus")
    with pytest.raises(ValueError, match="light_sample"):
        render(scene, cfg, _cam(), init_state(cfg), 1, 1)
