"""Hero-wavelength spectral sampling (cfg.hero_wavelengths, Wilkie et al.
2014): C rotated wavelengths share each camera path; the NEE emission term
averages their CIE responses and collapses to the hero's full-weight
emission on a dispersive interaction.

Pinned properties:
- the rotation adds NO RNG draws, so ray counts are identical to C=1;
- all backends (XLA integrator, regenerative megakernel, all three
  wavefront variants) agree exactly on ray counts with hero enabled;
- spectral chroma noise on an achromatic scene drops by >2x at C=4.
"""

import numpy as np

from tpurt import (
    RenderConfig,
    cornell_spheres_scene,
    dispersive_scene,
    make_camera,
)
from tpurt.render import init_state, render
from tpurt.scene import Light, Material, Sphere, build_scene

W, H = 64, 32


def _cam(scene_kind="cornell"):
    if scene_kind == "cornell":
        return make_camera((0, 5, -12), (0, 5, 0), vfov=60.0,
                           aspect_ratio=W / H)
    return make_camera((0, 3, -4), (0, 1, 5), vfov=55.0, aspect_ratio=W / H)


def test_ray_counts_unchanged_by_hero():
    scene = cornell_spheres_scene()
    rays = []
    for c in (1, 4):
        cfg = RenderConfig(width=W, height=H, depth=3, backend="xla",
                           hero_wavelengths=c, k_photons=1,
                           max_photon_bounces=2)
        st = render(scene, cfg, _cam(), init_state(cfg), 7, 2)
        rays.append(float(st.rays))
    assert rays[0] == rays[1] != 0.0


def test_cross_backend_exact_with_collapse():
    """XLA vs the regenerative megakernel, hero + dispersion on (the
    collapse-tracking path): exact ray-count parity."""
    scene = dispersive_scene()
    kw = dict(width=W, height=H, depth=4, k_photons=1, max_photon_bounces=2,
              hero_wavelengths=4, dispersion_in_camera_path=True,
              pallas_lanes=512, tile_size=512)
    st_x = render(scene, RenderConfig(backend="xla", **kw), _cam("disp"),
                  init_state(RenderConfig(backend="xla", **kw)), 77, 2)
    cfg_p = RenderConfig(backend="pallas", **kw)
    st_p = render(scene, cfg_p, _cam("disp"), init_state(cfg_p), 77, 2)
    assert float(st_x.rays) == float(st_p.rays) != 0.0
    a = np.asarray(st_x.rgb_sum)[:W * H]
    b = np.asarray(st_p.rgb_sum)[:W * H]
    assert abs(a.mean() - b.mean()) < 5e-3 * max(a.mean(), 1e-3)


def test_wavefront_variants_exact():
    from tpurt.wavefront import wavefront_render
    scene = dispersive_scene()
    cfg = RenderConfig(width=W, height=H, depth=3, enable_photons=False,
                       wf_pool=2048, hero_wavelengths=4,
                       dispersion_in_camera_path=True, pallas_lanes=512,
                       backend="pallas")
    rays = []
    for fn in (wavefront_render, render):  # pool wavefront, fused kernel
        st = fn(scene, cfg, _cam("disp"), init_state(cfg), 9, 2)
        rays.append(float(st.rays))
    assert len(set(rays)) == 1 and rays[0] != 0.0


def test_chroma_variance_reduction():
    """Achromatic scene: every color channel deviation is pure spectral
    noise; C=4 stratification must cut it by well over 2x."""
    mats = [Material.diffuse((0.75, 0.75, 0.75))]
    sph = [Sphere(0, 1000.0, (0.0, -1000.0, 0.0)),
           Sphere(0, 1.0, (0.0, 1.0, 4.0))]
    lights = [Light.square_area([0, 8, 4], [0, -1, 0], 2.0, [1, 1, 1],
                                10.0, 5500.0)]
    scene = build_scene(mats, sph, [], lights)
    cam = make_camera((0, 3, -4), (0, 1, 4), vfov=60.0, aspect_ratio=W / H)
    luma = np.array([0.2126, 0.7152, 0.0722])
    chroma = {}
    for c in (1, 4):
        cfg = RenderConfig(width=W, height=H, depth=3, backend="xla",
                           hero_wavelengths=c, enable_photons=False)
        st = render(scene, cfg, cam, init_state(cfg), 1000, 4)
        img = np.asarray(st.rgb_sum)[:W * H] / 4
        chroma[c] = np.sqrt(((img - (img @ luma)[:, None]) ** 2).mean())
    assert chroma[4] < 0.5 * chroma[1], chroma


def test_collapse_keeps_full_hero_weight():
    """Light transported THROUGH a dispersive dielectric must not dim with
    C (regression: the collapsed hero share was weighted 1/C, rendering
    glass interiors exactly C x too dark; the dirac continuation is
    hero-only so its MIS weight is 1 — cf. pbrt-v4 TerminateSecondary)."""
    mats = [Material.diffuse((0.8, 0.8, 0.8)), Material.dielectric(1.5, 0.0)]
    sph = [Sphere(0, 1000.0, (0.0, -1000.0, 0.0)),   # floor
           Sphere(1, 1.2, (0.0, 1.2, 3.0))]          # glass ball
    lights = [Light.point([0.0, 6.0, 3.0], [1, 1, 1], 40.0, 5500.0)]
    scene = build_scene(mats, sph, [], lights)
    cam = make_camera((0, 1.2, -1.0), (0, 1.2, 3.0), vfov=40.0,
                      aspect_ratio=W / H)
    luma = np.array([0.2126, 0.7152, 0.0722])
    mean_glass = {}
    for c in (1, 4):
        cfg = RenderConfig(width=W, height=H, depth=8, backend="xla",
                           hero_wavelengths=c, enable_photons=False,
                           dispersion_in_camera_path=True)
        st = render(scene, cfg, cam, init_state(cfg), 555, 96)
        img = (np.asarray(st.rgb_sum)[:W * H] / 96).reshape(H, W, 3)
        # central block: seen through the glass ball
        mean_glass[c] = float(
            (img[H // 2 - 4:H // 2 + 4, W // 2 - 8:W // 2 + 8] @ luma).mean())
    ratio = mean_glass[4] / mean_glass[1]
    assert 0.8 < ratio < 1.25, mean_glass
