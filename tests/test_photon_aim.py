"""Importance-aimed photon emission: cfg.photon_aim (EXTENSION; the
reference's area lights always emit cosine-hemisphere about the light
normal, ref: src/kernels/mega_kernel.wgsl:757-764).

Contract under test:
  * mixture normalization — the defensive-mixture weight p_cos/p_mix
    integrates the cosine target exactly: E_mix[w] = 1 over directions,
    for every q < 1 and every aim cone (the unbiasedness core);
  * aimed-cone geometry — aimed draws land inside the cone, uniformly;
  * estimator equivalence — any q in (0, 1) converges to the q=0
    (reference-sampling) image at equal spp;
  * validation — q >= 1 (no defensive component) and unsupported
    backends are rejected up front;
  * cross-backend exactness — XLA and the regenerative megakernel draw
    the same 3 extra uniforms in the same order, so ray counters stay
    exactly equal and images agree.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tpurt import Light, Material, RenderConfig, Sphere, build_scene, \
    make_camera
from tpurt.ops import soa
from tpurt.render import init_state, render

W, H = 32, 16


def _photon_scene():
    """Closed diffuse scene with a bright area light (same shape as the
    photon-RR suite's): photon contributions are a visible share of the
    image, so estimator drift would show."""
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


def _render(q, spp, seed=77, **extra):
    cfg = RenderConfig(width=W, height=H, depth=4, backend="xla",
                       photon_aim=q, k_photons=2,
                       max_photon_bounces=6, **extra)
    st = render(_photon_scene(), cfg, _cam(), init_state(cfg), seed, spp)
    return cfg, st


def test_mixture_weight_normalizes():
    """E_mix[p_cos / p_mix] = 1: draw N directions from the mixture
    (choice u < q -> uniform aim cone, else cosine hemisphere) and check
    the weight's mean — THE unbiasedness property, tested directly on
    the helper for several q and cone widths."""
    n = 200_000
    lnorm = (jnp.float32(0.0), jnp.float32(-1.0), jnp.float32(0.0))
    o = tuple(jnp.zeros((n,)) for _ in range(3))
    for q, aim, radius in (
        (0.5, (0.8, -3.0, 0.4), 0.5),
        (0.9, (0.0, -2.0, 0.0), 2.0),     # wide cone (clamped at 45 deg)
        (0.3, (4.0, -1.0, -3.0), 0.05),   # tight cone, oblique aim
    ):
        # plain numpy uniforms are fine here: the property is about the
        # *densities*, not any particular stream
        r = np.random.default_rng(5)
        uch = jnp.asarray(r.random(n), jnp.float32)
        ua = jnp.asarray(r.random(n), jnp.float32)
        ub = jnp.asarray(r.random(n), jnp.float32)
        u1 = jnp.asarray(r.random(n), jnp.float32)
        u2 = jnp.asarray(r.random(n), jnp.float32)
        aim_c = tuple(jnp.full((n,), v, jnp.float32) for v in aim)
        d_aim, ax, cos_a = soa.aimed_cone_c(
            o, aim_c, jnp.float32(radius), jnp.float32(3.0), ua, ub)
        d_cos = soa.cosine_hemisphere_c(lnorm, u1, u2)
        choose = uch < q
        d = soa.vwhere(choose, d_aim, d_cos)
        w = np.asarray(soa.aim_mixture_weight_c(
            d, lnorm, ax, cos_a, jnp.float32(q)))
        assert np.isfinite(w).all()
        se = w.std() / np.sqrt(n)
        assert abs(w.mean() - 1.0) < max(4.0 * se, 5e-3), \
            (q, aim, radius, w.mean(), se)


def test_aimed_cone_geometry():
    """Aimed draws stay inside the cone and cover it uniformly in the
    polar cosine (mean cos = (1 + cos_a) / 2)."""
    n = 50_000
    r = np.random.default_rng(9)
    ua = jnp.asarray(r.random(n), jnp.float32)
    ub = jnp.asarray(r.random(n), jnp.float32)
    o = tuple(jnp.zeros((n,)) for _ in range(3))
    aim = tuple(jnp.full((n,), v, jnp.float32) for v in (1.0, -4.0, 2.0))
    d, ax, cos_a = soa.aimed_cone_c(o, aim, jnp.float32(0.8),
                                    jnp.float32(3.0), ua, ub)
    ct = np.asarray(soa.vdot(d, ax))
    ca = float(np.asarray(cos_a)[0] if np.ndim(np.asarray(cos_a)) else cos_a)
    assert (ct >= ca - 1e-5).all()
    # unit length
    ln = np.asarray(soa.vlength(d))
    np.testing.assert_allclose(ln, 1.0, atol=1e-5)
    assert abs(ct.mean() - (1.0 + ca) / 2.0) < 2e-3
    # clamps: a huge radius clamps at AIM_SIN_MAX, a tiny one at AIM_SIN_MIN
    _, _, ca_wide = soa.aimed_cone_c(o, aim, jnp.float32(1e6),
                                     jnp.float32(3.0), ua, ub)
    _, _, ca_tight = soa.aimed_cone_c(o, aim, jnp.float32(1e-9),
                                      jnp.float32(3.0), ua, ub)
    np.testing.assert_allclose(
        np.asarray(ca_wide), np.sqrt(1 - soa.AIM_SIN_MAX ** 2), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(ca_tight), np.sqrt(1 - soa.AIM_SIN_MIN ** 2), atol=1e-6)


def test_aim_validation():
    scene = _photon_scene()
    for bad in (1.0, 1.5, -0.2):
        cfg = RenderConfig(width=W, height=H, photon_aim=bad)
        with pytest.raises(ValueError, match="photon_aim"):
            render(scene, cfg, _cam(), init_state(cfg), 1, 1)
    cfg = RenderConfig(width=W, height=H, photon_aim=0.5,
                       backend="wavefront", wf_pool=1024)
    with pytest.raises(NotImplementedError, match="photon_aim"):
        render(scene, cfg, _cam(), init_state(cfg), 1, 1)


def test_unbiased_vs_reference_sampling():
    """q in (0, 1) converges to the q=0 image: the camera term is
    bit-identical (aim draws come after the reference layout), so the
    comparison isolates the photon term."""
    means = {}
    for q in (0.0, 0.5):
        cfg, st = _render(q, spp=128, seed=345)
        img = np.asarray(st.rgb_sum)[:W * H] / 128.0
        assert np.isfinite(img).all()
        means[q] = img.mean(axis=0)
    np.testing.assert_allclose(means[0.5], means[0.0], rtol=0.05)


@pytest.mark.slow
def test_cross_backend_exact_rays():
    """XLA and the regenerative megakernel consume the same 3 extra
    aim draws in the same stream positions: ray counters exactly equal,
    images agree up to reassociation branch flips."""
    scene = _photon_scene()
    cam = _cam()
    kw = dict(width=W, height=H, depth=3, photon_aim=0.5,
              tile_size=512, pallas_lanes=512, k_photons=2,
              max_photon_bounces=4)
    results = {}
    for name, extra in (
        ("xla", dict(backend="xla")),
        ("regen", dict(backend="pallas")),
    ):
        cfg = RenderConfig(**kw, **extra)
        st = render(scene, cfg, cam, init_state(cfg), 99, 2)
        results[name] = (float(st.rays), np.asarray(st.rgb_sum)[:W * H])
    rays = {name: r for name, (r, _) in results.items()}
    assert len(set(rays.values())) == 1 and rays["xla"] != 0.0, rays
    ref = results["xla"][1]
    img = results["regen"][1]
    assert np.isfinite(img).all()
    assert abs(img.mean() - ref.mean()) < 5e-3 * max(ref.mean(), 1e-3)
    diverged = np.abs(img - ref).max(axis=-1) > 1e-3
    assert diverged.mean() < 0.02, diverged.mean()
