"""Camera motion blur (cfg.motion_blur + camera.MotionCamera — tpurt
extension; the reference has no shutter)."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpurt import RenderConfig, build_scene, cornell_spheres_scene, \
    make_camera, render, Light, Material, Sphere
from tpurt.camera import MotionCamera, base_camera
from tpurt.render import init_state, resolve_image


def _motion_cam(dx=0.0):
    c0 = make_camera((0., 5., -12.), (0., 5., 0.), vfov=60.0,
                     aspect_ratio=2.0)
    c1 = make_camera((dx, 5., -12.), (dx, 5., 0.), vfov=60.0,
                     aspect_ratio=2.0)
    return MotionCamera(cam0=c0, cam1=c1)


def _small_sphere_scene():
    """One small bright-lit sphere against black: the motion smear test."""
    return build_scene(
        materials=[Material.diffuse((0.9, 0.9, 0.9))],
        spheres=[Sphere(material_id=0, scale=0.4, translation=(0., 5., 0.))],
        lights=[Light.point(position=(0., 9., -6.), color=(1., 1., 1.),
                            intensity=50.0, color_temp=5500.0)])


class TestMotionBlur:
    def test_zero_delta_matches_static_distribution(self):
        """cam1 == cam0: every sample's geometry is the static camera's
        (only the stream shifts by the time draw) — images agree within
        MC noise and both are finite."""
        cfg = RenderConfig(width=64, height=32, depth=3, backend="xla",
                           enable_photons=False, motion_blur=True)
        scene = cornell_spheres_scene()
        mcam = _motion_cam(0.0)
        st_m = render(scene, cfg, mcam, init_state(cfg), 3, 64)
        st_s = render(scene, cfg.with_(motion_blur=False),
                      base_camera(mcam), init_state(cfg), 3, 64)
        a = np.asarray(resolve_image(cfg, st_m))
        b = np.asarray(resolve_image(cfg, st_s))
        assert np.isfinite(a).all()
        assert np.abs(a.mean() - b.mean()) < 0.02
        assert float(st_m.rays) > 0

    def test_smear_spreads_the_silhouette(self):
        """A fast sideways pan must light up pixels the static camera
        never covers (the smear) and dim the always-covered core."""
        cfg = RenderConfig(width=96, height=32, depth=2, backend="xla",
                           enable_photons=False, motion_blur=True)
        scene = _small_sphere_scene()
        st_m = render(scene, cfg, _motion_cam(dx=3.0), init_state(cfg),
                      5, 32)
        st_s = render(scene, cfg.with_(motion_blur=False),
                      _motion_cam().cam0, init_state(cfg), 5, 32)
        img_m = np.asarray(resolve_image(cfg, st_m)).mean(-1)
        img_s = np.asarray(resolve_image(cfg, st_s)).mean(-1)
        lit_m = img_m > 1e-3
        lit_s = img_s > 1e-3
        assert lit_m.sum() > 1.5 * lit_s.sum()          # smear widens
        core = img_s > 0.5 * img_s.max()
        # median, not mean: single-wavelength noise can spike one core
        # pixel far above the tonemap range
        assert np.median(img_m[core]) < 0.8 * np.median(img_s[core])

    @pytest.mark.slow
    def test_cross_backend_exact_rays(self):
        """XLA, regen megakernel, and fused wavefront draw identical
        streams with the shutter open."""
        cfg = RenderConfig(width=64, height=32, depth=3,
                           enable_photons=False, motion_blur=True,
                           backend="xla")
        scene = cornell_spheres_scene()
        mcam = _motion_cam(0.5)
        st_x = render(scene, cfg, mcam, init_state(cfg), 7, 4)

        cfg_p = cfg.with_(backend="pallas", pallas_lanes=512)
        st_p = render(scene, cfg_p, mcam, init_state(cfg_p), 7, 4)

        cfg_w = cfg.with_(backend="wavefront")
        st_w = render(scene, cfg_w, mcam, init_state(cfg_w), 7, 4)

        assert float(st_x.rays) == float(st_p.rays) != 0.0
        n = cfg.n_pixels
        for st_o in (st_p, st_w):
            a = np.asarray(st_x.rgb_sum)[:n]
            b = np.asarray(st_o.rgb_sum)[:n]
            assert (np.abs(a - b).max(axis=-1) > 1e-2).mean() < 0.02

    def test_camera_kind_mismatch_raises(self):
        cfg = RenderConfig(width=32, height=16, depth=2, backend="xla",
                           enable_photons=False, motion_blur=True)
        scene = cornell_spheres_scene()
        mcam = _motion_cam(0.5)
        with pytest.raises(TypeError, match="MotionCamera"):
            render(scene, cfg, mcam.cam0, init_state(cfg), 1, 1)
        with pytest.raises(TypeError, match="motion_blur"):
            render(scene, cfg.with_(motion_blur=False), mcam,
                   init_state(cfg), 1, 1)

    def test_composes_with_dof(self):
        cfg = RenderConfig(width=64, height=32, depth=2, backend="xla",
                           enable_photons=False, motion_blur=True,
                           aperture=0.4, focus_dist=12.0)
        scene = cornell_spheres_scene()
        st = render(scene, cfg, _motion_cam(0.5), init_state(cfg), 9, 4)
        assert np.isfinite(np.asarray(resolve_image(cfg, st))).all()
        assert float(st.rays) > 0
