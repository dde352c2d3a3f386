"""Type-3 emissive materials (Material.emissive — EXTENSION).

The reference's lights have no geometry and never appear in frame; a
type-3 surface adds color * cie_to_rgb(lambda) * range when a camera path
hits it (the lights' flat-spectrum emission form, wgsl :574-578) and the
path terminates; photons are absorbed; shadow rays see a full occluder.
"""

import numpy as np
import pytest

from tpurt import (Light, Material, RenderConfig, Sphere, build_scene,
                   make_camera, occlusion)
from tpurt.render import init_state, render, resolve_radiance

_WF = dict(wf_pool=4096, pallas_lanes=1024)
_BACKENDS = [
    ("xla", dict(backend="xla")),
    ("regen", dict(backend="pallas")),
    ("wf_xla", dict(backend="wavefront", **_WF)),
    # the fused kernel without the photon pass: the wavefront family's
    # per-lane-regeneration member
    ("wf_fused", dict(backend="pallas", enable_photons=False, **_WF)),
]


def _scene(intensity=12.0):
    return build_scene(
        materials=[Material.diffuse((0.7, 0.7, 0.7)),
                   Material.emissive((1.0, 0.6, 0.2), intensity)],
        spheres=[Sphere(material_id=0, scale=1000.0,
                        translation=(0, -1000, 0)),
                 Sphere(material_id=1, scale=0.7, translation=(0, 1.2, 4))],
        lights=[Light.point((3, 4, 2), (1, 1, 1), 3.0, 5500.0)])


_CAM = make_camera((0, 1.2, 0), (0, 1.2, 4), vfov=50.0, aspect_ratio=1.0)


def _run(scene, kw, spp=8, seed=3, **cfg_kw):
    cfg = RenderConfig(width=32, height=32, depth=5, **kw, **cfg_kw)
    st = render(scene, cfg, _CAM, init_state(cfg), seed, spp)
    return float(st.rays), np.asarray(resolve_radiance(cfg, st))


def test_emission_linear_and_indirect():
    """Doubling the emitter intensity exactly doubles the image (the
    emission never enters path decisions), and the emitter lights the
    scene indirectly (floor pixels > 0 with the light removed)."""
    s1 = build_scene(
        materials=[Material.diffuse((0.7, 0.7, 0.7)),
                   Material.emissive((1.0, 0.6, 0.2), 6.0)],
        spheres=[Sphere(material_id=0, scale=1000.0,
                        translation=(0, -1000, 0)),
                 Sphere(material_id=1, scale=0.7, translation=(0, 1.2, 4))],
        lights=[])
    s2 = build_scene(
        materials=[Material.diffuse((0.7, 0.7, 0.7)),
                   Material.emissive((1.0, 0.6, 0.2), 12.0)],
        spheres=[Sphere(material_id=0, scale=1000.0,
                        translation=(0, -1000, 0)),
                 Sphere(material_id=1, scale=0.7, translation=(0, 1.2, 4))],
        lights=[])
    r1, img1 = _run(s1, dict(backend="xla"), spp=16)
    r2, img2 = _run(s2, dict(backend="xla"), spp=16)
    assert r1 == r2  # identical paths
    np.testing.assert_allclose(img2, 2.0 * img1, rtol=1e-5)
    # emitter tint dominates (R > G > B like the color 1/.6/.2)
    em = img2[12:20, 12:20].mean((0, 1))
    assert em[0] > em[1] > em[2] > 0
    # floor (bottom rows) is lit purely by the emitter
    assert img2[-6:].mean() > 0.0


def test_camera_terminates_at_emitter():
    """An emitter filling the whole FOV: every camera lane dies at its
    first hit — exactly one segment per sample, no NEE (no diffuse
    lanes), no photons (no lights). Without the termination gate the
    type-3 surface would fall into the dielectric scatter branch and
    keep bouncing (rays >> W*H*spp)."""
    scene = build_scene(
        materials=[Material.emissive((1.0, 1.0, 1.0), 1.0)],
        spheres=[Sphere(material_id=0, scale=50.0, translation=(0, 1.2, 55))],
        lights=[])
    cfg = RenderConfig(width=16, height=16, depth=30, backend="xla")
    st = render(scene, cfg, _CAM, init_state(cfg), 5, 4)
    assert float(st.rays) == 16 * 16 * 4
    rad = np.asarray(resolve_radiance(cfg, st))
    # per-pixel channels can be negative at low spp (out-of-gamut
    # single-lambda samples); the channel means must be positive
    assert np.isfinite(rad).all() and (rad.mean((0, 1)) > 0).all()


def test_emitter_occludes_shadow_rays():
    """Type-3 surfaces block shadow rays fully (like diffuse)."""
    scene = build_scene(
        materials=[Material.diffuse((0.7, 0.7, 0.7)),
                   Material.emissive((1.0, 1.0, 1.0), 1.0)],
        spheres=[Sphere(material_id=0, scale=1000.0,
                        translation=(0, -1000, 0)),
                 Sphere(material_id=1, scale=1.0, translation=(0, 2, 0))],
        lights=[])
    o = np.array([[0.0, 0.01, 0.0]], np.float32)   # floor point under it
    up = np.array([[0.0, 1.0, 0.0]], np.float32)
    occ = occlusion(scene, o, up, t_max=np.array([10.0], np.float32))
    assert float(np.asarray(occ)[0]) == 0.0


def test_cross_backend_exact():
    scene = _scene()
    res = {label: _run(scene, kw) for label, kw in _BACKENDS}
    # photons: mega family traces them, wavefront family doesn't
    assert res["xla"][0] == res["regen"][0]
    assert res["wf_xla"][0] == res["wf_fused"][0]
    base = res["xla"][1]
    for label, (_, rad) in res.items():
        if label.startswith("wf"):
            base_cmp = res["wf_xla"][1]
        else:
            base_cmp = base
        rel = np.abs(rad - base_cmp) / np.maximum(np.abs(base_cmp), 1.0)
        assert float(rel.max()) < 1e-3, label


@pytest.mark.slow
def test_hero_collapse_emissive_cross_backend():
    """hero + dispersion: the type-3 emission base collapses to the hero's
    share alongside the light/sky emissions in every backend."""
    scene = build_scene(
        materials=[Material.diffuse((0.7, 0.7, 0.7)),
                   Material.dielectric(1.5, 0.0),
                   Material.emissive((0.4, 0.8, 1.0), 8.0)],
        spheres=[Sphere(material_id=0, scale=1000.0,
                        translation=(0, -1000, 0)),
                 Sphere(material_id=1, scale=0.8, translation=(-0.9, 1, 4)),
                 Sphere(material_id=2, scale=0.6, translation=(1.1, 1, 4))],
        lights=[Light.point((3, 4, 2), (1, 1, 1), 3.0, 5500.0)])
    res = {}
    for label, kw in _BACKENDS:
        res[label] = _run(scene, kw, hero_wavelengths=4,
                          dispersion_in_camera_path=True,
                          sky_intensity=0.2)
    assert res["xla"][0] == res["regen"][0]
    assert res["wf_xla"][0] == res["wf_fused"][0]
    for fam_base, members in (("xla", ("regen",)),
                              ("wf_xla", ("wf_fused",))):
        base = res[fam_base][1]
        for label in members:
            rel = np.abs(res[label][1] - base) / np.maximum(np.abs(base), 1.0)
            flips = (rel.max(-1) > 1e-3).mean()
            assert flips < 0.01, f"{label}: {flips}"
