"""Depth of field (tpurt extension — the reference camera is pinhole-only):
cfg.aperture + cfg.focus_dist thin-lens sampling (camera.lens_perturb)."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpurt import (RenderConfig, cornell_spheres_scene, make_camera, render)
from tpurt.camera import generate_rays, lens_perturb, lens_perturb_c
from tpurt.ops import rng as rngmod
from tpurt.render import init_state, resolve_image


def _cam(vfov=60.0, aspect=1.5):
    return make_camera((0., 5., -12.), (0., 5., 0.), vfov=vfov,
                       aspect_ratio=aspect)


class TestLensSampling:
    def _rays(self, n=4096):
        cam = _cam()
        u = jnp.linspace(0.1, 0.9, n)
        v = jnp.full((n,), 0.4)
        o, d = generate_rays(cam, u, v)
        rng = rngmod.seed_pixels(jnp.uint32(7), jnp.arange(n),
                                 jnp.zeros(n, jnp.int32))
        return cam, o, d, rng

    def test_focal_point_preserved(self):
        """(o, d) -> (o+off, d-off/F): the t==F point o + F*d lies on the
        focal plane and is preserved to float rounding."""
        cam, o, d, rng = self._rays()
        F = 4.0
        o2, d2, _ = lens_perturb(cam, 0.6, F, o, d, rng)
        assert np.allclose(np.asarray(o + F * d), np.asarray(o2 + F * d2),
                           rtol=1e-5, atol=1e-4)
        assert not np.allclose(np.asarray(o), np.asarray(o2))

    def test_offsets_fill_the_lens_disc(self):
        cam, o, d, rng = self._rays()
        ap = 0.6
        o2, _, _ = lens_perturb(cam, ap, 4.0, o, d, rng)
        off = np.asarray(o2 - o)
        rad = np.linalg.norm(off, axis=-1)
        assert rad.max() <= ap / 2 + 1e-5
        assert rad.max() > 0.45 * ap / 2          # actually spreads out
        assert np.abs(off.mean(axis=0)).max() < 0.01   # centered
        # offsets lie in the viewport plane (orthogonal to view direction)
        h = np.asarray(cam.horizontal); v = np.asarray(cam.vertical)
        w = np.cross(h / np.linalg.norm(h), v / np.linalg.norm(v))
        assert np.abs(off @ w).max() < 1e-5

    def test_component_form_matches_vector_form(self):
        cam, o, d, rng = self._rays(n=512)
        o_a, d_a, rng_a = lens_perturb(cam, 0.4, 3.0, o, d, rng)
        ot = tuple(o[:, c] for c in range(3))
        dt = tuple(d[:, c] for c in range(3))
        ht = tuple(cam.horizontal[c] for c in range(3))
        vt = tuple(cam.vertical[c] for c in range(3))
        o_b, d_b, rng_b = lens_perturb_c(0.4, 3.0, rng, ot, dt, ht, vt,
                                         rngmod.rand_1f)
        for c in range(3):
            assert (np.asarray(o_a[:, c]) == np.asarray(o_b[c])).all()
            assert (np.asarray(d_a[:, c]) == np.asarray(d_b[c])).all()
        assert (np.asarray(rng_a) == np.asarray(rng_b)).all()

    def test_tiny_sphere_at_focal_point_always_hit(self):
        """Every lens sample's ray passes through the pinhole ray's t==F
        point: a tiny sphere there is hit by ALL perturbed rays, while the
        same sphere at half the distance is missed by wide-lens rays."""
        from tpurt.ops.intersect import sphere_candidates
        cam = _cam()
        F = 6.0
        n = 2048
        u = jnp.full((n,), 0.5)
        v = jnp.full((n,), 0.5)
        o, d = generate_rays(cam, u, v)
        rng = rngmod.seed_pixels(jnp.uint32(3), jnp.arange(n),
                                 jnp.ones(n, jnp.int32))
        o2, d2, _ = lens_perturb(cam, 0.8, F, o, d, rng)
        focal_pt = np.asarray(o + F * d)[0]
        eps_r = 0.02   # small vs the lens (0.4 radius) but large enough for
        #                the f32 sphere-quadratic discriminant at |c| ~ 6
        t, valid = sphere_candidates(o2, d2, jnp.asarray(focal_pt)[None, :],
                                     jnp.asarray([eps_r]))
        assert bool(np.asarray(valid).all())
        near_pt = np.asarray(o)[0] + 0.5 * F * np.asarray(d)[0]
        t, valid = sphere_candidates(o2, d2, jnp.asarray(near_pt)[None, :],
                                     jnp.asarray([eps_r]))
        assert np.asarray(valid).mean() < 0.05


class TestDofValidation:
    def test_zero_focus_raises_clearly(self):
        import pytest
        cam, o, d = _cam(), *generate_rays(
            _cam(), jnp.asarray([0.5]), jnp.asarray([0.5]))
        rng = rngmod.seed_pixels(jnp.uint32(1), jnp.zeros(1, jnp.int32),
                                 jnp.zeros(1, jnp.int32))
        with pytest.raises(ValueError, match="focus_dist"):
            lens_perturb(cam, 0.5, 0.0, o, d, rng)

    def test_cli_zero_overrides_scene_file(self, tmp_path):
        """--aperture 0 must beat a scene file's camera aperture (the CLI
        default is None, not 0, so explicit zero is distinguishable)."""
        import argparse, json, sys, os
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        sys.path.insert(0, root)
        import viewer
        doc = json.load(open(os.path.join(root, "examples/cornell.json")))
        doc["camera"].update(aperture=0.5, focus_dist=6.0)
        p = tmp_path / "s.json"
        p.write_text(json.dumps(doc))
        base = dict(scene_file=str(p), scene="cornell", width=64, height=36,
                    depth=2, backend="xla", hero=1, dispersion=False,
                    clamp=0.0)
        cfg, *_ = viewer._build(argparse.Namespace(
            **base, aperture=None, focus=None))
        assert cfg.aperture == 0.5 and cfg.focus_dist == 6.0
        cfg0, *_ = viewer._build(argparse.Namespace(
            **base, aperture=0.0, focus=None))
        assert cfg0.aperture == 0.0


@pytest.mark.slow
class TestDofBackends:
    def _setup(self, backend, **kw):
        cfg = RenderConfig(width=64, height=32, depth=4, backend=backend,
                           enable_photons=False, aperture=0.5,
                           focus_dist=12.0, **kw)
        scene = cornell_spheres_scene()
        cam = make_camera((0., 5., -12.), (0., 5., 0.), vfov=60.0,
                          aspect_ratio=2.0)
        return cfg, scene, cam

    def test_aperture_zero_is_bit_identical(self):
        """aperture=0 must compile to exactly the reference sampling —
        focus_dist alone may never perturb anything."""
        cfg, scene, cam = self._setup("xla")
        st_a = render(scene, cfg.with_(aperture=0.0, focus_dist=5.0), cam,
                      init_state(cfg), 9, 4)
        st_b = render(scene, cfg.with_(aperture=0.0, focus_dist=1.0), cam,
                      init_state(cfg), 9, 4)
        assert (np.asarray(st_a.rgb_sum) == np.asarray(st_b.rgb_sum)).all()
        assert float(st_a.rays) == float(st_b.rays) != 0.0

    def test_dof_changes_the_image(self):
        cfg, scene, cam = self._setup("xla")
        st_d = render(scene, cfg, cam, init_state(cfg), 9, 8)
        st_p = render(scene, cfg.with_(aperture=0.0), cam,
                      init_state(cfg), 9, 8)
        img_d = np.asarray(resolve_image(cfg, st_d))
        img_p = np.asarray(resolve_image(cfg, st_p))
        assert np.isfinite(img_d).all()
        assert np.abs(img_d - img_p).max() > 1e-3

    def test_cross_backend_exact_rays_close_images(self):
        """XLA, regen megakernel, and pool wavefront draw identical
        streams with aperture on: exact ray parity, images agree except
        rare reassociation branch flips."""
        cfg, scene, cam = self._setup("xla")
        st_x = render(scene, cfg, cam, init_state(cfg), 9, 4)

        cfg_p, _, _ = self._setup("pallas", pallas_lanes=512)
        st_p = render(scene, cfg_p, cam, init_state(cfg_p), 9, 4)

        cfg_w, _, _ = self._setup("wavefront")
        st_w = render(scene, cfg_w, cam, init_state(cfg_w), 9, 4)

        assert float(st_x.rays) == float(st_p.rays) != 0.0
        n = 64 * 32
        for st_o in (st_p, st_w):
            a = np.asarray(st_x.rgb_sum)[:n]
            b = np.asarray(st_o.rgb_sum)[:n]
            assert (np.abs(a - b).max(axis=-1) > 1e-2).mean() < 0.02
