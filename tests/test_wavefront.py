"""Wavefront (persistent ray pool + regeneration) tests.

The wavefront tracer enumerates the same per-(pixel, sample) PCG streams as
the progressive renderer, so with photons disabled the two must agree to
float accumulation noise — a much stronger check than statistical matching.
(ref: src/wavefront.rs / src/kernels/wavefront.wgsl — the unfinished
reference component this replaces; see tpurt/wavefront.py docstring.)
"""

import numpy as np

from tpurt import RenderConfig, cornell_spheres_scene, make_camera
from tpurt.render import init_state, render
from tpurt.wavefront import wavefront_render


def _setup(**kw):
    cfg = RenderConfig(width=48, height=24, depth=4, tile_size=1152,
                       enable_photons=False, **kw)
    scene = cornell_spheres_scene()
    cam = make_camera((0.0, 5.0, -12.0), (0.0, 5.0, 0.0), vfov=60.0,
                      aspect_ratio=2.0)
    return cfg, scene, cam


class TestWavefront:
    def test_matches_progressive(self):
        cfg, scene, cam = _setup(wf_pool=2048)
        st_w = wavefront_render(scene, cfg, cam, init_state(cfg), 42, 3)
        st_p = render(scene, cfg, cam, init_state(cfg), 42, 3)
        n = cfg.n_pixels
        a = np.asarray(st_w.rgb_sum)[:n]
        b = np.asarray(st_p.rgb_sum)[:n]
        # identical work items -> identical segment count
        assert float(st_w.rays) == float(st_p.rays) != 0.0
        np.testing.assert_allclose(a, b, atol=2e-2, rtol=1e-3)

    def test_every_pixel_gets_spp_samples(self):
        cfg, scene, cam = _setup(wf_pool=512)  # pool << pixel count
        st = wavefront_render(scene, cfg, cam, init_state(cfg), 7, 2)
        ns = np.asarray(st.n_samples)[:cfg.n_pixels]
        assert (ns == 2.0).all()

    def test_progressive_continuation_draws_new_samples(self):
        """Two 2-spp calls must equal one 4-spp call: the second call's
        samples are offset by the carried iteration (regression: they
        used to re-trace samples 0-1 bit-identically — no convergence)."""
        cfg, scene, cam = _setup(wf_pool=2048)
        st_a = wavefront_render(scene, cfg, cam, init_state(cfg), 42, 2)
        st_a = wavefront_render(scene, cfg, cam, st_a, 42, 2)
        st_b = wavefront_render(scene, cfg, cam, init_state(cfg), 42, 4)
        assert int(st_a.iteration) == int(st_b.iteration) == 4
        assert float(st_a.rays) == float(st_b.rays) != 0.0
        n = cfg.n_pixels
        np.testing.assert_allclose(np.asarray(st_a.rgb_sum)[:n],
                                   np.asarray(st_b.rgb_sum)[:n],
                                   atol=1e-5, rtol=1e-5)

    def test_small_pool_same_image(self):
        """Pool capacity must not change the result, only the schedule."""
        cfg_a, scene, cam = _setup(wf_pool=256)
        cfg_b, _, _ = _setup(wf_pool=4096)
        st_a = wavefront_render(scene, cfg_a, cam, init_state(cfg_a), 9, 2)
        st_b = wavefront_render(scene, cfg_b, cam, init_state(cfg_b), 9, 2)
        n = cfg_a.n_pixels
        np.testing.assert_allclose(np.asarray(st_a.rgb_sum)[:n],
                                   np.asarray(st_b.rgb_sum)[:n],
                                   atol=2e-2, rtol=1e-3)
        assert float(st_a.rays) == float(st_b.rays)

    def test_sky_gradient_flag(self):
        """Legacy wavefront sky (wavefront.wgsl:129-131) adds energy on
        miss; black sky (mega kernel) does not."""
        cfg, scene, cam = _setup(wf_pool=1024)
        cfg_sky = cfg.with_(sky_gradient=True)
        st_k = wavefront_render(scene, cfg, cam, init_state(cfg), 3, 1)
        st_s = wavefront_render(scene, cfg_sky, cam, init_state(cfg_sky), 3, 1)
        n = cfg.n_pixels
        assert np.asarray(st_s.rgb_sum)[:n].sum() > np.asarray(st_k.rgb_sum)[:n].sum()


class TestWavefrontBackendDispatch:
    """cfg.backend makes every wavefront tracer reachable through the
    public render() entry point (VERDICT r1: config 5 needed a lambda)."""

    def test_backend_wavefront_bit_identical(self):
        # both paths use the SAME cfg: the dispatch pads the state to the
        # pool-lane multiple (render.padded_pixels), so a direct call with
        # an xla-backend cfg would differ in state SHAPE (not values)
        cfg, scene, cam = _setup(wf_pool=2048)
        wcfg = cfg.with_(backend="wavefront")
        st_d = render(scene, wcfg, cam, init_state(wcfg), 42, 2)
        st_w = wavefront_render(scene, wcfg, cam, init_state(wcfg), 42, 2)
        np.testing.assert_array_equal(np.asarray(st_d.rgb_sum),
                                      np.asarray(st_w.rgb_sum))
        assert float(st_d.rays) == float(st_w.rays) != 0.0

    def test_render_step_dispatches(self):
        cfg, scene, cam = _setup(wf_pool=1024, backend="wavefront")
        from tpurt.render import render_step
        st = render_step(scene, cfg, cam, init_state(cfg), 7)
        assert int(st.iteration) == 1
        assert float(st.rays) > 0


class TestWavefrontPallas:
    def test_fused_matches_xla(self):
        """The regenerative megakernel with the photon pass off draws the
        same camera-path + NEE streams as the XLA pool wavefront."""
        from tpurt.render import render
        cfg, scene, cam = _setup(backend="pallas", pallas_lanes=512)
        assert not cfg.enable_photons
        st_x = wavefront_render(scene, cfg, cam, init_state(cfg), 42, 3)
        st_f = render(scene, cfg, cam, init_state(cfg), 42, 3)
        assert float(st_x.rays) == float(st_f.rays) != 0.0
        n = cfg.n_pixels
        ns = np.asarray(st_f.n_samples)[:n]
        assert (ns == 3.0).all()
        a = np.asarray(st_x.rgb_sum)[:n]
        b = np.asarray(st_f.rgb_sum)[:n]
        # dispersive branch flips diverge whole pixels — 2% like above
        assert (np.abs(a - b).max(axis=-1) > 1e-2).mean() < 0.02
        assert abs(a.mean() - b.mean()) < 5e-3 * max(abs(a.mean()), 1e-3)


class TestWavefrontSharded:
    def test_sharded_bit_exact_vs_slab_sequential(self):
        """8-device sharded wavefront == the same slabs drained one at a
        time on one device (same code path -> bit-exact), and == the
        whole-image single pool up to float splat order. The slab split
        (48x22 px, tile 64) covers full, partial, and all-padding slabs."""
        import dataclasses

        import jax
        import jax.numpy as jnp

        from tpurt.parallel import sharding as sh
        from tpurt.render import RenderState
        from tpurt.wavefront import wavefront_render_slab

        assert len(jax.devices()) >= 8
        cfg = RenderConfig(width=48, height=22, depth=4, tile_size=64,
                           enable_photons=False, backend="wavefront",
                           wf_pool=256)
        scene = cornell_spheres_scene()
        cam = make_camera((0.0, 5.0, -12.0), (0.0, 5.0, 0.0), vfov=60.0,
                          aspect_ratio=48 / 22)

        mesh = sh.make_mesh(8)
        state = sh.init_state_sharded(cfg, mesh)
        Pn = state.rgb_sum.shape[0]
        Pl = Pn // 8
        # the split this test is designed around: 5 full slabs, 1 partial,
        # 2 all-padding
        assert Pl * 5 < cfg.n_pixels < Pl * 6
        step = sh.make_wavefront_sharded_step(mesh, cfg, spp=3)
        st = step(scene, cam, state, jnp.uint32(42))

        assert int(st.iteration) == 3
        ns = np.asarray(st.n_samples)
        assert (ns[:cfg.n_pixels] == 3.0).all()
        assert (ns[cfg.n_pixels:] == 0.0).all()

        # sequential per-slab comparator: the identical per-device body
        slab_fn = jax.jit(wavefront_render_slab, static_argnames=("cfg",))
        rgb_parts, rays_total = [], 0.0
        for d in range(8):
            z3 = jnp.zeros((Pl, 3), jnp.float32)
            loc = RenderState(
                rgb_sum=z3, n_samples=jnp.zeros((Pl,), jnp.float32),
                vis_pos=z3, vis_norm=z3, vis_wo=z3, vis_tp=z3,
                vis_mat=jnp.zeros((Pl,), jnp.int32),
                iteration=jnp.zeros((), jnp.int32),
                photon_radius=jnp.asarray(cfg.photon_radius_init,
                                          jnp.float32),
                rays=jnp.zeros((), jnp.float32))
            off = d * Pl
            nv = max(0, min(cfg.n_pixels - off, Pl))
            out = slab_fn(scene, cfg, cam, loc, jnp.uint32(42),
                          jnp.int32(3), jnp.int32(off), jnp.int32(nv))
            rgb_parts.append(np.asarray(out.rgb_sum))
            rays_total += float(out.rays)
        np.testing.assert_array_equal(np.asarray(st.rgb_sum),
                                      np.concatenate(rgb_parts))
        assert float(st.rays) == rays_total != 0.0

        # whole-image single pool: identical (pixel, sample) paths, so the
        # segment count matches EXACTLY; radiance only up to splat order
        wcfg = dataclasses.replace(cfg, wf_pool=2048)
        st1 = wavefront_render(scene, wcfg, cam, init_state(wcfg),
                               jnp.uint32(42), 3)
        assert float(st1.rays) == float(st.rays)
        n = cfg.n_pixels
        np.testing.assert_allclose(np.asarray(st.rgb_sum)[:n],
                                   np.asarray(st1.rgb_sum)[:n],
                                   atol=1e-5, rtol=1e-5)

    def test_requires_wavefront_backend(self):
        import pytest

        from tpurt.parallel import sharding as sh
        cfg = RenderConfig(width=8, height=8, backend="pallas")
        with pytest.raises(ValueError, match="wavefront"):
            sh.make_wavefront_sharded_step(sh.make_mesh(2), cfg)


class TestSampleSharded:
    def test_camera_only_matches_single_chip(self):
        """8-device sample sharding (device d renders samples [d*m,(d+1)*m)
        of the full image) == the single-chip spp-sample run: exact ray
        parity and per-pixel radiance up to float summation order."""
        import jax
        import jax.numpy as jnp

        from tpurt.parallel import sharding as sh
        from tpurt.render import _render_xla

        assert len(jax.devices()) >= 8
        cfg = RenderConfig(width=32, height=16, depth=3, tile_size=512,
                           enable_photons=False, backend="xla")
        scene = cornell_spheres_scene()
        cam = make_camera((0.0, 5.0, -12.0), (0.0, 5.0, 0.0), vfov=60.0,
                          aspect_ratio=2.0)
        mesh = sh.make_mesh(8)
        step = sh.make_sample_sharded_step(mesh, cfg, spp=8)
        st = step(scene, cam, init_state(cfg), jnp.uint32(5))

        st1 = _render_xla(scene, cfg, cam, init_state(cfg), jnp.uint32(5), 8)
        n = cfg.n_pixels
        assert int(st.iteration) == 8
        assert float(st.rays) == float(st1.rays) != 0.0
        assert float(st.photon_radius) == float(st1.photon_radius)
        assert (np.asarray(st.n_samples)[:n] == 8.0).all()
        np.testing.assert_allclose(np.asarray(st.rgb_sum)[:n],
                                   np.asarray(st1.rgb_sum)[:n],
                                   atol=1e-5, rtol=1e-5)

    def test_photons_blockwise_warmup_bounded(self):
        """With the SPPM photon pass on, vispoint persistence is blockwise
        (documented in make_sample_sharded_step): photon lanes are live
        only while their pixel has a vispoint, so each block's first
        samples trace slightly fewer photon segments than the sequential
        run (the reference's own first-frame warmup). Pin that the deficit
        stays a warmup-sized effect and the radius schedule is exact."""
        import jax
        import jax.numpy as jnp

        from tpurt.parallel import sharding as sh
        from tpurt.render import _render_xla

        cfg = RenderConfig(width=16, height=8, depth=3, tile_size=128,
                           backend="xla", k_photons=2, max_photon_bounces=2)
        scene = cornell_spheres_scene()
        cam = make_camera((0.0, 5.0, -12.0), (0.0, 5.0, 0.0), vfov=60.0,
                          aspect_ratio=2.0)
        mesh = sh.make_mesh(8)
        step = sh.make_sample_sharded_step(mesh, cfg, spp=8)
        st = step(scene, cam, init_state(cfg), jnp.uint32(3))
        st1 = _render_xla(scene, cfg, cam, init_state(cfg), jnp.uint32(3), 8)
        r, r1 = float(st.rays), float(st1.rays)
        assert 0.0 < r <= r1, "blockwise warmup can only LOSE photon lanes"
        assert (r1 - r) / r1 < 0.03, f"warmup deficit too large: {r} vs {r1}"
        assert float(st.photon_radius) == float(st1.photon_radius)
        # deposits agree per-pixel wherever vispoint persistence never
        # crossed a block boundary; globally the estimator stays close
        n = cfg.n_pixels
        a = np.asarray(st.rgb_sum)[:n]
        b = np.asarray(st1.rgb_sum)[:n]
        assert abs(a.mean() - b.mean()) < 0.05 * max(abs(b.mean()), 1e-3)

    def test_spp_must_divide(self):
        import pytest

        from tpurt.parallel import sharding as sh
        cfg = RenderConfig(width=8, height=8, backend="xla")
        with pytest.raises(ValueError, match="multiple"):
            sh.make_sample_sharded_step(sh.make_mesh(8), cfg, spp=12)


class TestWavefrontDispatchContracts:
    def test_render_step_depth_override_honored(self):
        """render_step(depth=1) on a wavefront backend must trace the
        depth-1 preview (it used to silently run cfg.depth bounces)."""
        from tpurt.render import render_step
        cfg, scene, cam = _setup(wf_pool=2048, backend="wavefront")
        st_prev = render_step(scene, cfg, cam, init_state(cfg), 42, depth=1)
        st_full = render_step(scene, cfg, cam, init_state(cfg), 42)
        assert 0.0 < float(st_prev.rays) < float(st_full.rays)
        # the override is exactly the depth-1 config's render
        cfg1 = cfg.with_(depth=1)
        st_ref = wavefront_render(scene, cfg1, cam, init_state(cfg1), 42, 1)
        assert float(st_prev.rays) == float(st_ref.rays)
        np.testing.assert_array_equal(np.asarray(st_prev.rgb_sum),
                                      np.asarray(st_ref.rgb_sum))

    def test_camera_strata_bounce_rejected(self):
        """The wavefront tracers draw the unstratified camera sequence —
        accepting camera_strata_bounce would silently break same-seed
        parity with the other backends, so it must raise."""
        import pytest

        from tpurt.render import render
        cfg, scene, cam = _setup(wf_pool=512, backend="wavefront",
                                 photon_strata=16,
                                 camera_strata_bounce=True)
        with pytest.raises(ValueError, match="camera_strata_bounce"):
            render(scene, cfg, cam, init_state(cfg), 42, 1)

