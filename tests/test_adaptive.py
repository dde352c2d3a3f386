"""Adaptive-sampling tests (tpurt/adaptive.py — beyond-reference extension).

The budget renderer's contract is exact: pixel p's k-th sample draws the
same PCG stream as every other backend, and a uniform budget reproduces the
uniform wavefront tracer's flat work enumeration bit-for-bit. Nonuniform
budgets are pinned against per-sample deltas of the uniform tracer.
"""

import numpy as np
import jax.numpy as jnp

from tpurt import RenderConfig, cornell_spheres_scene, make_camera
from tpurt.adaptive import (
    allocate_budgets,
    render_adaptive,
    variance_proxy,
    wavefront_render_budget,
)
from tpurt.render import init_state, resolve_image
from tpurt.wavefront import wavefront_render


def _setup(**kw):
    cfg = RenderConfig(width=48, height=24, depth=4, tile_size=1152,
                       enable_photons=False, **kw)
    scene = cornell_spheres_scene()
    cam = make_camera((0.0, 5.0, -12.0), (0.0, 5.0, 0.0), vfov=60.0,
                      aspect_ratio=2.0)
    return cfg, scene, cam


def _pad_budgets(cfg, values):
    from tpurt.render import padded_pixels
    b = np.zeros((padded_pixels(cfg),), np.int32)
    b[:cfg.n_pixels] = values
    return jnp.asarray(b)


class TestBudgetRenderer:
    def test_uniform_budget_bit_identical(self):
        """budgets == spp everywhere must reproduce wavefront_render's
        enumeration exactly — same issue order, same pool schedule, same
        float adds — so the states match to the bit."""
        cfg, scene, cam = _setup(wf_pool=512)  # pool << pixel count
        spp = 3
        st_u = wavefront_render(scene, cfg, cam, init_state(cfg), 42, spp)
        st_b = wavefront_render_budget(
            scene, cfg, cam, init_state(cfg), 42,
            _pad_budgets(cfg, spp), max_budget=spp)
        assert (np.asarray(st_u.rgb_sum) == np.asarray(st_b.rgb_sum)).all()
        assert (np.asarray(st_u.n_samples)
                == np.asarray(st_b.n_samples)).all()
        assert float(st_u.rays) == float(st_b.rays) != 0.0
        assert int(st_u.iteration) == int(st_b.iteration) == spp

    def test_nonuniform_budget_exact_counts_and_sums(self):
        """Every pixel gets exactly budgets[p] samples, and its sum equals
        the sum of that pixel's first budgets[p] per-sample contributions
        (taken from successive 1-spp uniform renders)."""
        cfg, scene, cam = _setup(wf_pool=256)
        rng = np.random.default_rng(5)
        maxb = 5
        vals = rng.integers(0, maxb + 1, cfg.n_pixels)
        budgets = _pad_budgets(cfg, vals)

        st = wavefront_render_budget(scene, cfg, cam, init_state(cfg), 9,
                                     budgets, max_budget=maxb)
        ns = np.asarray(st.n_samples)[:cfg.n_pixels]
        assert (ns == vals).all()

        # per-sample deltas from the uniform tracer
        deltas = []
        prev = init_state(cfg)
        prev_sum = np.asarray(prev.rgb_sum)
        for _ in range(maxb):
            prev = wavefront_render(scene, cfg, cam, prev, 9, 1)
            cur = np.asarray(prev.rgb_sum)
            deltas.append(cur - prev_sum)
            prev_sum = cur
        expect = np.zeros_like(prev_sum)
        for k, d in enumerate(deltas):
            expect += np.where((vals > k)[:, None], d[:cfg.n_pixels], 0.0)
        got = np.asarray(st.rgb_sum)[:cfg.n_pixels]
        np.testing.assert_allclose(got, expect[:cfg.n_pixels],
                                   atol=1e-5, rtol=1e-5)

    def test_budget_continuation_draws_new_samples(self):
        """Two budget calls must equal one combined call: the second
        continues each pixel at its own accumulated count."""
        cfg, scene, cam = _setup(wf_pool=1024)
        rng = np.random.default_rng(11)
        b1 = rng.integers(0, 3, cfg.n_pixels)
        b2 = rng.integers(0, 3, cfg.n_pixels)
        st_a = wavefront_render_budget(scene, cfg, cam, init_state(cfg), 3,
                                       _pad_budgets(cfg, b1), max_budget=2)
        st_a = wavefront_render_budget(scene, cfg, cam, st_a, 3,
                                       _pad_budgets(cfg, b2), max_budget=2)
        st_b = wavefront_render_budget(scene, cfg, cam, init_state(cfg), 3,
                                       _pad_budgets(cfg, b1 + b2),
                                       max_budget=4)
        n = cfg.n_pixels
        assert (np.asarray(st_a.n_samples)[:n]
                == np.asarray(st_b.n_samples)[:n]).all()
        assert float(st_a.rays) == float(st_b.rays) != 0.0
        np.testing.assert_allclose(np.asarray(st_a.rgb_sum)[:n],
                                   np.asarray(st_b.rgb_sum)[:n],
                                   atol=1e-5, rtol=1e-5)

    def test_zero_budget_is_noop(self):
        cfg, scene, cam = _setup(wf_pool=256)
        st0 = init_state(cfg)
        st = wavefront_render_budget(scene, cfg, cam, st0, 1,
                                     _pad_budgets(cfg, 0), max_budget=1)
        assert float(jnp.sum(st.n_samples)) == 0.0
        assert float(st.rays) == 0.0


class TestBudgetRegen:
    """Per-lane budgets in the regenerative megakernel: adaptive sampling
    with the FULL estimator (photons + per-pixel SPPM radius schedule)."""

    def _setup(self, **kw):
        cfg = RenderConfig(width=64, height=32, depth=3, backend="pallas",
                           pallas_lanes=512, k_photons=2,
                           max_photon_bounces=3, **kw)
        scene = cornell_spheres_scene()
        cam = make_camera((0.0, 5.0, -12.0), (0.0, 5.0, 0.0), vfov=60.0,
                          aspect_ratio=2.0)
        return cfg, scene, cam

    def test_uniform_budget_bit_identical_to_render_regen(self):
        from tpurt.kernels.mega_regen import (render_budget_regen,
                                              render_regen)
        cfg, scene, cam = self._setup()
        st0 = init_state(cfg)
        st_u = render_regen(scene, cfg, cam, st0, 42, 2)
        st_b = render_budget_regen(scene, cfg, cam, st0, 42,
                                   _pad_budgets(cfg, 2), 2)
        assert (np.asarray(st_u.rgb_sum) == np.asarray(st_b.rgb_sum)).all()
        assert (np.asarray(st_u.vis_pos) == np.asarray(st_b.vis_pos)).all()
        assert float(st_u.rays) == float(st_b.rays) != 0.0
        assert float(st_u.photon_radius) == float(st_b.photon_radius)

    def test_budget_equals_uniform_prefix_per_pixel(self):
        """THE oracle: pixels are independent, so pixel p after budget b_p
        must equal pixel p of a uniform render after exactly b_p samples —
        bit-for-bit, including the photon pass and its radius schedule."""
        from tpurt.kernels.mega_regen import (render_budget_regen,
                                              render_regen)
        cfg, scene, cam = self._setup()
        st0 = init_state(cfg)
        rng = np.random.default_rng(3)
        vals = rng.integers(0, 4, cfg.n_pixels)
        st_b = render_budget_regen(scene, cfg, cam, st0, 42,
                                   _pad_budgets(cfg, vals), 3)
        prefix = [np.asarray(st0.rgb_sum)]
        st = st0
        for _ in range(3):
            st = render_regen(scene, cfg, cam, st, 42, 1)
            prefix.append(np.asarray(st.rgb_sum))
        got = np.asarray(st_b.rgb_sum)[: cfg.n_pixels]
        want = np.stack(prefix)[vals, np.arange(cfg.n_pixels)]
        assert (got == want).all()
        ns = np.asarray(st_b.n_samples)[: cfg.n_pixels]
        assert (ns == vals).all()

    def test_two_budget_calls_equal_one(self):
        from tpurt.kernels.mega_regen import render_budget_regen
        cfg, scene, cam = self._setup()
        st0 = init_state(cfg)
        rng = np.random.default_rng(4)
        b1 = rng.integers(0, 3, cfg.n_pixels)
        b2 = rng.integers(0, 3, cfg.n_pixels)
        st_a = render_budget_regen(scene, cfg, cam, st0, 7,
                                   _pad_budgets(cfg, b1), 2)
        st_a = render_budget_regen(scene, cfg, cam, st_a, 7,
                                   _pad_budgets(cfg, b2), 2)
        st_c = render_budget_regen(scene, cfg, cam, st0, 7,
                                   _pad_budgets(cfg, b1 + b2), 4)
        assert (np.asarray(st_a.rgb_sum) == np.asarray(st_c.rgb_sum)).all()
        assert float(st_a.rays) == float(st_c.rays) != 0.0

    def test_render_adaptive_dispatches_regen(self):
        cfg, scene, cam = self._setup()
        st, budgets = render_adaptive(scene, cfg, cam, base_seed=5,
                                      spp=5, pilot_spp=2)
        n = cfg.n_pixels
        ns = np.asarray(st.n_samples)[:n]
        assert (ns == 2 + np.asarray(budgets)[:n]).all()
        assert np.isfinite(np.asarray(resolve_image(cfg, st))).all()


class TestBudgetSharded:
    def test_sharded_bit_exact_vs_slab_sequential(self):
        """8-device sharded budget render == the same slabs drained one at
        a time on one device (same code path -> bit-exact), and == the
        whole-image budget pool up to float splat order (exact ray parity).
        The 48x22/tile-64 split covers full, partial, and all-padding
        slabs; the budget map is nonuniform across the whole image."""
        import dataclasses

        import jax

        from tpurt.adaptive import wavefront_render_budget_slab
        from tpurt.parallel import sharding as sh
        from tpurt.render import RenderState

        assert len(jax.devices()) >= 8
        cfg = RenderConfig(width=48, height=22, depth=4, tile_size=64,
                           enable_photons=False, backend="wavefront",
                           wf_pool=256)
        scene = cornell_spheres_scene()
        cam = make_camera((0.0, 5.0, -12.0), (0.0, 5.0, 0.0), vfov=60.0,
                          aspect_ratio=48 / 22)
        maxb = 4

        mesh = sh.make_mesh(8)
        state = sh.init_state_sharded(cfg, mesh)
        Pn = state.rgb_sum.shape[0]
        Pl = Pn // 8
        assert Pl * 5 < cfg.n_pixels < Pl * 6
        rng = np.random.default_rng(3)
        bud_np = np.zeros((Pn,), np.int32)
        bud_np[:cfg.n_pixels] = rng.integers(0, maxb + 1, cfg.n_pixels)
        budgets = jax.device_put(
            jnp.asarray(bud_np),
            jax.sharding.NamedSharding(mesh,
                                       jax.sharding.PartitionSpec(sh.AXIS)))

        step = sh.make_wavefront_budget_sharded_step(mesh, cfg, maxb)
        st = step(scene, cam, state, jnp.uint32(42), budgets)
        ns = np.asarray(st.n_samples)
        assert (ns == bud_np).all()

        # sequential per-slab comparator: the identical per-device body
        slab_fn = jax.jit(wavefront_render_budget_slab,
                          static_argnames=("cfg", "max_budget"))
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
            out = slab_fn(scene, cfg, cam, loc, jnp.uint32(42),
                          jnp.asarray(bud_np[off:off + Pl]), maxb,
                          jnp.int32(off))
            rgb_parts.append(np.asarray(out.rgb_sum))
            rays_total += float(out.rays)
        np.testing.assert_array_equal(np.asarray(st.rgb_sum),
                                      np.concatenate(rgb_parts))
        assert float(st.rays) == rays_total != 0.0

        # whole-image single pool: identical (pixel, sample) paths ->
        # exact segment parity; radiance up to splat order
        wcfg = dataclasses.replace(cfg, wf_pool=2048)
        st1 = wavefront_render_budget(
            scene, wcfg, cam, init_state(wcfg), jnp.uint32(42),
            _pad_budgets(wcfg, bud_np[:cfg.n_pixels]), max_budget=maxb)
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
            sh.make_wavefront_budget_sharded_step(sh.make_mesh(2), cfg, 4)


class TestAdaptiveDriver:
    def test_end_to_end(self):
        cfg, scene, cam = _setup(wf_pool=1024)
        spp, pilot = 8, 4
        st, budgets = render_adaptive(scene, cfg, cam, base_seed=17,
                                      spp=spp, pilot_spp=pilot)
        n = cfg.n_pixels
        ns = np.asarray(st.n_samples)[:n]
        b = np.asarray(budgets)[:n]
        # every pixel: pilot + its allocated budget, no more, no less
        assert (ns == pilot + b).all()
        # the allocator spends roughly the requested remainder
        want = (spp - pilot) * n
        assert abs(int(b.sum()) - want) <= n  # rounding slack
        img = np.asarray(resolve_image(cfg, st))
        assert np.isfinite(img).all()

    def test_proxy_floor_keeps_coverage(self):
        """Even pixels whose half-estimates agree exactly keep a nonzero
        proxy (the relative floor), so they can still be allocated."""
        cfg, scene, cam = _setup()
        P = init_state(cfg).rgb_sum.shape[0]
        sum_a = jnp.ones((P, 3)) * 2.0
        sum_b = jnp.ones((P, 3)) * 2.0
        ns = jnp.ones((P,))
        proxy = variance_proxy(cfg, sum_a, ns, sum_b, ns)
        p = np.asarray(proxy)
        assert (p[:cfg.n_pixels] > 0).all()
        assert (p[cfg.n_pixels:] == 0).all()

    def test_allocator_proportionality(self):
        proxy = jnp.asarray(
            np.r_[np.full(500, 1.0), np.full(500, 3.0)], jnp.float32)
        b = np.asarray(allocate_budgets(proxy, total=8000, max_budget=100,
                                        power=1.0))
        assert abs(b[:500].mean() - 4.0) < 0.01
        assert abs(b[500:].mean() - 12.0) < 0.01
        # default power 0.5: same total, 1:sqrt(3) split
        b = np.asarray(allocate_budgets(proxy, total=8000, max_budget=100))
        assert abs(b.sum() - 8000) <= 1000  # rounding slack
        w = np.sqrt(3.0)
        assert abs(b[500:].mean() / b[:500].mean() - w) < 0.1  # int rounding

    def test_validation(self):
        cfg, scene, cam = _setup()
        import pytest
        with pytest.raises(ValueError):
            render_adaptive(scene, cfg, cam, spp=8, pilot_spp=3)
        with pytest.raises(ValueError):
            render_adaptive(scene, cfg, cam, spp=2, pilot_spp=4)
