"""Photon Russian-roulette scaling: cfg.photon_rr_scale (EXTENSION over
the reference RR — wgsl :855-858 kills with p = max_c(tp)).

Contract under test:
  * estimator equivalence — any scale > 0 converges to the scale-1
    image (survival min(max_c(tp), 1) * scale, survivors reweighted by
    1/(max_c(tp) * scale): the per-bounce expectation equals the
    reference RR's for every throughput, including the reference's
    prob > 1 normalize-down regime);
  * segment reduction — scale < 1 strictly reduces the traced-segment
    counter (photon walks terminate earlier);
  * reference exactness at 1.0 — the scaled branch is never emitted, so
    the default estimator is bit-identical to the reference RR;
  * cross-backend exactness — the scale changes no draws (u_rr is
    consumed either way), so ray counters stay exact across backends.
"""

import numpy as np
import pytest

from tpurt import Light, Material, RenderConfig, Sphere, build_scene, \
    make_camera
from tpurt.render import init_state, render

W, H = 32, 16


def _photon_scene():
    """Closed diffuse scene with a bright area light: photon walks live
    long enough (high albedo) that RR is the dominant terminator."""
    mats = [Material.diffuse((0.80, 0.80, 0.80)),
            Material.diffuse((0.70, 0.35, 0.35))]
    sph = [Sphere(0, 1000.0, (0.0, -1000.0, 0.0)),   # floor
           Sphere(0, 1000.0, (0.0, 1012.0, 0.0)),    # ceiling
           Sphere(1, 1.5, (0.0, 1.5, 5.0)),
           Sphere(0, 1.0, (-2.5, 1.0, 4.0))]
    lights = [Light.square_area([0.0, 9.0, 5.0], [0.0, -1.0, 0.0], 1.5,
                                [1.0, 0.9, 0.8], 20.0, 5500.0)]
    return build_scene(mats, sph, [], lights)


def _cam():
    return make_camera((0.0, 3.0, -6.0), (0.0, 1.5, 5.0), vfov=55.0,
                       aspect_ratio=W / H)


def _render(scale, spp, seed=77, **extra):
    cfg = RenderConfig(width=W, height=H, depth=4, backend="xla",
                       photon_rr_scale=scale, k_photons=2,
                       max_photon_bounces=6, **extra)
    st = render(_photon_scene(), cfg, _cam(), init_state(cfg), seed, spp)
    return cfg, st


def test_scale_reduces_segments():
    """scale < 1 kills photons earlier: strictly fewer traced segments,
    and more aggressive scales kill more."""
    rays = {}
    for scale in (1.0, 0.5, 0.25):
        _, st = _render(scale, spp=4)
        rays[scale] = float(st.rays)
    assert rays[0.25] < rays[0.5] < rays[1.0], rays
    assert rays[0.25] > 0.0


def test_scale_validation():
    # > 1 is rejected too: u_rr < 1 caps effective survival at 1 while
    # the reweight divides by prob*scale — it would bias photons darker
    for bad in (0.0, -0.5, 1.5):
        cfg = RenderConfig(width=W, height=H, photon_rr_scale=bad)
        with pytest.raises(ValueError, match="photon_rr_scale"):
            render(_photon_scene(), cfg, _cam(), init_state(cfg), 1, 1)


def test_unbiased_vs_reference_rr():
    """The scaled estimator converges to the scale-1 (reference RR)
    image: mean radiance agrees within MC noise at equal spp."""
    means = {}
    for scale in (1.0, 0.5):
        cfg, st = _render(scale, spp=128, seed=345)
        img = np.asarray(st.rgb_sum)[:W * H] / 128.0
        assert np.isfinite(img).all()
        means[scale] = img.mean(axis=0)
    np.testing.assert_allclose(means[0.5], means[1.0], rtol=0.05)


@pytest.mark.slow
def test_cross_backend_exact_rays():
    """scale consumes no extra draws, so the xla / regen
    ray counters stay EXACTLY equal with the flag on, and images agree
    up to reassociation branch flips."""
    scene = _photon_scene()
    cam = _cam()
    kw = dict(width=W, height=H, depth=3, photon_rr_scale=0.5,
              tile_size=512, pallas_lanes=512, k_photons=2,
              max_photon_bounces=4)
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
