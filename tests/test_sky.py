"""Environment emission (cfg.sky_intensity — EXTENSION).

The reference's sky returns black (mega_kernel.wgsl:617-620); tpurt's
environment emitter turns the camera-path miss branch of every backend
into a spectral emitter with the lights' emission form (wgsl :574-578).
These tests pin:
- the classic furnace invariant (an albedo-1 diffuse sphere under a
  constant sky is indistinguishable from the sky),
- cross-backend exactness (no extra RNG draws/segments; images agree),
- blackbody tinting and the gradient ramp,
- hero-wavelength/dispersive-collapse handling of the sky emission.
"""

import numpy as np
import pytest

from tpurt import (Light, Material, RenderConfig, Sphere, build_scene,
                   make_camera)
from tpurt.render import init_state, render, resolve_radiance


def _furnace_scene():
    return build_scene(
        materials=[Material.diffuse((1.0, 1.0, 1.0))],
        spheres=[Sphere(material_id=0, scale=1.0, translation=(0, 0, 3))],
        lights=[])


_CAM = make_camera((0, 0, 0), (0, 0, 3), vfov=45.0, aspect_ratio=1.0)

_WF = dict(wf_pool=4096, pallas_lanes=1024)
_BACKENDS = [
    ("xla", dict(backend="xla")),
    ("regen", dict(backend="pallas")),
    ("wf_xla", dict(backend="wavefront", **_WF)),
    # the fused kernel without the photon pass: the wavefront family's
    # per-lane-regeneration member
    ("wf_fused", dict(backend="pallas", enable_photons=False, **_WF)),
]


def _rad(scene, cfg, spp, seed=11):
    st = render(scene, cfg, _CAM, init_state(cfg), seed, spp)
    return float(st.rays), np.asarray(resolve_radiance(cfg, st))


def test_furnace_constant_sky():
    """Albedo-1 Lambertian sphere under a constant sky: f*cos/pdf == 1, so
    the sphere region converges to the sky radiance itself (per channel)."""
    scene = _furnace_scene()
    cfg = RenderConfig(width=48, height=48, depth=6, backend="xla",
                       sky_intensity=1.0)
    _, rad = _rad(scene, cfg, 192)
    sphere = rad[18:30, 18:30].mean((0, 1))
    bg = np.concatenate([rad[:6, :6], rad[:6, -6:],
                         rad[-6:, :6], rad[-6:, -6:]]).mean((0, 1))
    assert np.isfinite(rad).all()
    ratio = sphere / bg
    np.testing.assert_allclose(ratio, 1.0, atol=0.08,
                               err_msg=f"furnace broken: {ratio}")


def test_cross_backend_furnace_exact():
    """Sky adds no RNG draws or segments: every backend's ray counter is
    unchanged by the flag, counts agree across the board on a photon-free
    scene, and the images match to reassociation noise."""
    scene = _furnace_scene()
    res = {}
    for label, kw in _BACKENDS:
        cfg = RenderConfig(width=32, height=32, depth=6,
                           sky_intensity=1.0, **kw)
        res[label] = _rad(scene, cfg, 8)
        # counts invariant under the flag
        cfg0 = RenderConfig(width=32, height=32, depth=6, **kw)
        rays0, rad0 = _rad(scene, cfg0, 8)
        assert rays0 == res[label][0], label
        assert float(np.abs(rad0).max()) == 0.0, label  # black without sky
    counts = {v[0] for v in res.values()}
    assert counts == {res["xla"][0]}
    base = res["xla"][1]
    for label, (rays, rad) in res.items():
        np.testing.assert_allclose(rad, base, atol=5e-3, err_msg=label)


def test_blackbody_sky_tint():
    scene = _furnace_scene()
    means = {}
    for temp in (2500.0, 10000.0):
        cfg = RenderConfig(width=32, height=32, depth=4, backend="xla",
                           sky_intensity=1.0, sky_temp=temp)
        _, rad = _rad(scene, cfg, 64)
        means[temp] = rad.mean((0, 1))
    assert means[2500.0][0] > means[2500.0][2]    # warm: R > B
    assert means[10000.0][2] > means[10000.0][0]  # cold: B > R


def test_gradient_tint_and_sky_color():
    """With sky_gradient the tint ramps white -> (.5,.7,1) by direction
    height: looking at the horizon, upper background rows are bluer
    (B/R rises) than lower rows. sky_color scales channels globally."""
    scene = build_scene(materials=[Material.diffuse((0.5, 0.5, 0.5))],
                        spheres=[], lights=[])
    cam = make_camera((0, 0, 0), (0, 0, 1), vfov=90.0, aspect_ratio=1.0)
    cfg = RenderConfig(width=32, height=32, depth=2, backend="xla",
                       sky_intensity=1.0, sky_gradient=True)
    st = render(scene, cfg, cam, init_state(cfg), 3, 32)
    rad = np.asarray(resolve_radiance(cfg, st))
    top = rad[:8].mean((0, 1))
    bot = rad[-8:].mean((0, 1))
    assert top[2] / top[0] > bot[2] / bot[0] * 1.2

    cfg_red = RenderConfig(width=32, height=32, depth=2, backend="xla",
                           sky_intensity=1.0, sky_color=(1.0, 0.0, 0.0))
    st = render(scene, cfg_red, cam, init_state(cfg_red), 3, 32)
    red = np.asarray(resolve_radiance(cfg_red, st))
    assert red[..., 0].mean() > 0.0
    # G/B are scaled to exactly zero by the tint
    assert float(np.abs(red[..., 1:]).max()) == 0.0


@pytest.mark.slow
def test_hero_collapse_sky_cross_backend():
    """hero_wavelengths + dispersion: the sky emission collapses to the
    hero's full-weight share alongside the light emissions, identically
    in every backend (the wavefront kernels rewrite their sky planes,
    the mega backends select by the collapse bit)."""
    scene = build_scene(
        materials=[Material.diffuse((0.8, 0.8, 0.8)),
                   Material.dielectric(1.5, 0.0)],
        spheres=[Sphere(material_id=1, scale=1.0, translation=(0, 0, 3)),
                 Sphere(material_id=0, scale=0.5, translation=(1.2, 0, 4))],
        lights=[Light.point((0, 4, 3), (1, 1, 1), 5.0, 5500.0)])
    res = {}
    for label, kw in _BACKENDS:
        cfg = RenderConfig(width=32, height=32, depth=8, sky_intensity=0.5,
                           sky_temp=6500.0, sky_gradient=True,
                           hero_wavelengths=4,
                           dispersion_in_camera_path=True, **kw)
        st = render(scene, cfg, _CAM, init_state(cfg), 7, 8)
        res[label] = (float(st.rays), np.asarray(resolve_radiance(cfg, st)))
    # mega family traces photons, the wavefront family doesn't; counts are
    # exact within each family
    assert res["regen"][0] == res["xla"][0]
    assert res["wf_fused"][0] == res["wf_xla"][0]
    base = res["xla"][1]
    for label, (_, rad) in res.items():
        flips = (np.abs(rad - base).max(-1) > 1e-3).mean()
        assert flips < 0.01, f"{label}: flip frac {flips}"
