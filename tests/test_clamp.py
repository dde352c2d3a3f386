"""Per-sample radiance clamp (cfg.radiance_clamp — tpurt extension; the
reference has no firefly control)."""

import numpy as np
import pytest

from tpurt import RenderConfig, cornell_spheres_scene, make_camera, render
from tpurt.render import init_state

# the cross-backend case compiles two Pallas kernels in interpret mode
pytestmark = pytest.mark.slow


def _setup(backend="xla", **kw):
    cfg = RenderConfig(width=64, height=32, depth=4, backend=backend,
                       k_photons=2, max_photon_bounces=3,
                       radiance_clamp=2.0, **kw)
    scene = cornell_spheres_scene()
    cam = make_camera((0., 5., -12.), (0., 5., 0.), vfov=60.0,
                      aspect_ratio=2.0)
    return cfg, scene, cam


class TestRadianceClamp:
    def test_clamp_bounds_accumulation_channelwise(self):
        """min is monotone, so every accumulated channel sum is <= the
        unclamped sum, and a 1-spp resolve is <= the clamp value."""
        cfg, scene, cam = _setup()
        st_c = render(scene, cfg, cam, init_state(cfg), 11, 1)
        st_u = render(scene, cfg.with_(radiance_clamp=0.0), cam,
                      init_state(cfg), 11, 1)
        a = np.asarray(st_c.rgb_sum)
        b = np.asarray(st_u.rgb_sum)
        assert (a <= b + 1e-6).all()
        assert a.max() <= 2.0 + 1e-6
        assert float(st_c.rays) == float(st_u.rays) != 0.0
        assert (a != b).any()            # the Cornell box does firefly

    def test_huge_clamp_is_identity(self):
        cfg, scene, cam = _setup()
        st_c = render(scene, cfg.with_(radiance_clamp=1e9), cam,
                      init_state(cfg), 11, 2)
        st_u = render(scene, cfg.with_(radiance_clamp=0.0), cam,
                      init_state(cfg), 11, 2)
        assert (np.asarray(st_c.rgb_sum) == np.asarray(st_u.rgb_sum)).all()

    def test_cross_backend_parity_with_clamp(self):
        """The clamp applies at the same estimator point everywhere: exact
        ray parity, images agree except rare reassociation flips."""
        cfg, scene, cam = _setup()
        st_x = render(scene, cfg, cam, init_state(cfg), 11, 2)

        cfg_p, _, _ = _setup(backend="pallas", pallas_lanes=512)
        st_p = render(scene, cfg_p, cam, init_state(cfg_p), 11, 2)

        cfg_w, _, _ = _setup(backend="pallas", pallas_lanes=512,
                             enable_photons=False)
        st_wx = render(scene, cfg_w.with_(backend="wavefront"), cam,
                       init_state(cfg_w), 11, 2)
        st_w = render(scene, cfg_w, cam, init_state(cfg_w), 11, 2)

        assert float(st_x.rays) == float(st_p.rays) != 0.0
        assert float(st_w.rays) == float(st_wx.rays) != 0.0
        n = cfg.n_pixels
        for a_st, b_st in ((st_x, st_p), (st_wx, st_w)):
            a = np.asarray(a_st.rgb_sum)[:n]
            b = np.asarray(b_st.rgb_sum)[:n]
            assert (np.abs(a - b).max(axis=-1) > 1e-2).mean() < 0.02
