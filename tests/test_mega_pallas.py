"""Pallas megakernel vs XLA integrator parity (SURVEY.md §7 step 5).

Both backends implement the same physics with bit-exact PCG RNG streams and
identical draw order, so for the same seed they must produce the same image
up to float reassociation. A tiny fraction of lanes may flip a near-threshold
branch (hit test, RR) and diverge entirely — the assertions are therefore on
the ray count (must match exactly: masks are reassociation-robust in
aggregate), the mean image, and the fraction of divergent pixels.

Runs on CPU: the kernel goes through the Pallas interpreter (interpret
mode is chosen by tpurt.runtime.pallas_interpret on the CPU).
"""

import numpy as np
import pytest

from tpurt import (
    RenderConfig,
    cornell_spheres_scene,
    default_scene,
    dispersive_scene,
    make_camera,
)
from tpurt.render import init_state, render, render_step


def _run_pair(scene, cfg_kw, spp=1, seed=77):
    cfg_x = RenderConfig(backend="xla", **cfg_kw)
    cfg_p = RenderConfig(backend="pallas", **cfg_kw)
    cam = make_camera((0.0, 5.0, -12.0), (0.0, 5.0, 0.0), vfov=60.0,
                      aspect_ratio=cfg_x.width / cfg_x.height)
    st_x = render(scene, cfg_x, cam, init_state(cfg_x), seed, spp)
    st_p = render(scene, cfg_p, cam, init_state(cfg_p), seed, spp)
    return st_x, st_p


def _assert_close(st_x, st_p, n_pixels, frac_tol=0.01):
    a = np.asarray(st_x.rgb_sum)[:n_pixels]
    b = np.asarray(st_p.rgb_sum)[:n_pixels]
    assert np.isfinite(a).all() and np.isfinite(b).all()
    # identical RNG streams -> identical masks -> identical ray counts
    # (pallas pads to its own tile unit; compare only when paddings match)
    assert abs(a.mean() - b.mean()) < 5e-3 * max(a.mean(), 1e-3)
    diverged = np.abs(a - b).max(axis=-1) > 1e-3
    assert diverged.mean() < frac_tol, f"{diverged.mean():.2%} pixels diverged"


class TestMegaPallasParity:
    def test_cornell_spheres(self):
        scene = cornell_spheres_scene()
        cfg_kw = dict(width=64, height=32, depth=4, tile_size=2048,
                      pallas_lanes=2048, k_photons=2, max_photon_bounces=3)
        st_x, st_p = _run_pair(scene, cfg_kw)
        # same padded size -> ray counters must match exactly
        assert float(st_x.rays) == float(st_p.rays) != 0.0
        _assert_close(st_x, st_p, 64 * 32)

    def test_multi_spp_schedule(self):
        """Radius schedule + iteration bookkeeping agree across 3 samples."""
        scene = cornell_spheres_scene()
        cfg_kw = dict(width=32, height=16, depth=3, tile_size=512,
                      pallas_lanes=512, k_photons=1, max_photon_bounces=2)
        st_x, st_p = _run_pair(scene, cfg_kw, spp=3)
        assert int(st_x.iteration) == int(st_p.iteration) == 3
        np.testing.assert_allclose(float(st_x.photon_radius),
                                   float(st_p.photon_radius), rtol=1e-6)
        assert float(st_x.rays) == float(st_p.rays)
        _assert_close(st_x, st_p, 32 * 16)

    def test_default_scene_spheres(self):
        """Sphere-only variant of the reference default scene, with the
        dielectric + 5500K area light (exercises blackbody + dispersion)."""
        scene = default_scene()  # no obj asset -> spheres only
        if scene.num_triangles > 0:
            pytest.skip("default scene picked up a mesh")
        # fused-kernel tiles are 128 x a power of two lanes
        cfg_kw = dict(width=48, height=24, depth=5, tile_size=1152,
                      pallas_lanes=1024, k_photons=2, max_photon_bounces=4)
        st_x, st_p = _run_pair(scene, cfg_kw)
        _assert_close(st_x, st_p, 48 * 24, frac_tol=0.02)

    def test_dispersive_camera_path(self):
        scene = dispersive_scene()
        if scene.num_triangles > 0:
            pytest.skip("dispersive scene has a mesh")
        cfg_kw = dict(width=32, height=16, depth=4, tile_size=512,
                      pallas_lanes=512, dispersion_in_camera_path=True,
                      k_photons=1, max_photon_bounces=2)
        st_x, st_p = _run_pair(scene, cfg_kw)
        _assert_close(st_x, st_p, 32 * 16, frac_tol=0.02)

    def test_triangles_static_and_dynamic(self):
        """Mesh scenes in the kernel: unrolled and table triangle
        sweeps both match the XLA integrator exactly on ray counts."""
        from tpurt.scene import tri_test_scene
        scene = tri_test_scene()
        assert scene.num_triangles > 0
        cam = make_camera((0.0, 2.0, -6.0), (0.0, 1.0, 0.0), vfov=60.0,
                          aspect_ratio=2.0)
        kw = dict(width=64, height=32, depth=3, tile_size=2048,
                  pallas_lanes=2048, k_photons=1, max_photon_bounces=2)
        cfg_x = RenderConfig(backend="xla", **kw)
        st_x = render(scene, cfg_x, cam, init_state(cfg_x), 5, 2)
        for unroll in (32, 1):  # static / dynamic triangle modes
            cfg_p = RenderConfig(backend="pallas",
                                 pallas_static_unroll=unroll, **kw)
            st_p = render(scene, cfg_p, cam, init_state(cfg_p), 5, 2)
            assert float(st_p.rays) == float(st_x.rays)
            n = 64 * 32  # padded sizes differ (block tiles); compare pixels
            a = np.asarray(st_x.rgb_sum)[:n]
            b = np.asarray(st_p.rgb_sum)[:n]
            assert (np.abs(a - b).max(axis=-1) > 1e-3).mean() < 0.01

    def test_vispoints_persist(self):
        """Vispoint planes survive across steps (render_step single-step
        path) and the photon pass reads the updated ones."""
        scene = cornell_spheres_scene()
        cfg = RenderConfig(width=32, height=16, depth=3, backend="pallas",
                           pallas_lanes=512, k_photons=1,
                           max_photon_bounces=2)
        cam = make_camera((0.0, 5.0, -12.0), (0.0, 5.0, 0.0), vfov=60.0,
                          aspect_ratio=2.0)
        st = init_state(cfg)
        st = render_step(scene, cfg, cam, st, 3)
        vp1 = np.asarray(st.vis_pos)
        assert (np.linalg.norm(vp1, axis=-1) > 1e-3).any()
        st = render_step(scene, cfg, cam, st, 3)
        assert int(st.iteration) == 2
        assert float(st.photon_radius) < 2.0


class TestMetalMaterial:
    def test_metal_parity_all_backends(self):
        """Material type 2 (GGX conductor, scene.Material.metal): XLA,
        Pallas, and wavefront agree exactly on ray counts."""
        from tpurt import dispersive_scene
        from tpurt.wavefront import wavefront_render
        scene = dispersive_scene()  # includes a gold metal sphere
        cam = make_camera((0.0, 3.0, -4.0), (0.0, 1.0, 5.0), vfov=55.0,
                          aspect_ratio=2.0)
        kw = dict(width=48, height=24, depth=4, tile_size=1152,
                  pallas_lanes=1152 - 1152 % 128 if (1152 % 128) else 1152,
                  k_photons=1, max_photon_bounces=2,
                  dispersion_in_camera_path=True)
        kw["pallas_lanes"] = 1024
        kw["tile_size"] = 1024
        cfg_x = RenderConfig(backend="xla", **kw)
        cfg_p = RenderConfig(backend="pallas", **kw)
        st_x = render(scene, cfg_x, cam, init_state(cfg_x), 5, 2)
        st_p = render(scene, cfg_p, cam, init_state(cfg_p), 5, 2)
        n = cfg_x.n_pixels
        a = np.asarray(st_x.rgb_sum)[:n]
        b = np.asarray(st_p.rgb_sum)[:n]
        assert np.isfinite(a).all() and np.isfinite(b).all()
        assert abs(a.mean() - b.mean()) < 5e-3 * max(a.mean(), 1e-3)

        cfg_w = cfg_x.with_(enable_photons=False, wf_pool=1024)
        st_w = wavefront_render(scene, cfg_w, cam, init_state(cfg_w), 5, 2)
        st_n = render(scene, cfg_w, cam, init_state(cfg_w), 5, 2)
        assert float(st_w.rays) == float(st_n.rays) != 0.0

    def test_metal_reflects_energy(self):
        """A smooth metal mirror between camera and light contributes via
        reflected diffuse paths; its F0 tints the result."""
        from tpurt import Light, Material, Sphere, build_scene
        mats = [Material.diffuse((0.8, 0.8, 0.8)),
                Material.metal((1.0, 0.2, 0.2), 0.0)]
        scene = build_scene(
            materials=mats,
            spheres=[Sphere(0, 1000.0, (0, -1000.5, 0)),
                     Sphere(1, 1.0, (0, 1.0, 3.0))],
            lights=[Light.point([0, 6, 0], [1, 1, 1], 30.0, 5500.0)],
        )
        cfg = RenderConfig(width=32, height=16, depth=4, tile_size=512,
                           pallas_lanes=512, k_photons=1,
                           max_photon_bounces=2, backend="pallas")
        cam = make_camera((0, 1, -3), (0, 1, 3), vfov=60.0, aspect_ratio=2.0)
        st = render(scene, cfg, cam, init_state(cfg), 9, 8)
        img = np.asarray(st.rgb_sum)[:cfg.n_pixels]
        assert np.isfinite(img).all()
        assert img.sum() > 0.0


class TestRegenKernel:
    def test_default_dispatch_uses_regen(self):
        """backend='pallas' + pallas_regen (default) renders correctly
        through render()."""
        scene = cornell_spheres_scene()
        cam = make_camera((0.0, 5.0, -12.0), (0.0, 5.0, 0.0), vfov=60.0,
                          aspect_ratio=2.0)
        cfg = RenderConfig(width=32, height=16, depth=3, backend="pallas",
                           pallas_lanes=512, k_photons=1,
                           max_photon_bounces=2)
        st = render(scene, cfg, cam, init_state(cfg), 3, 4)
        assert int(st.iteration) == 4
        img = np.asarray(st.rgb_sum)[:cfg.n_pixels]
        assert np.isfinite(img).all() and img.sum() > 0

    def test_progressive_continuation_exact(self):
        """2 spp then 2 more == 4 spp straight: the regen kernel folds
        state.iteration into its per-sample seeds (regression: it used to
        restart at sample 0 every call and re-render identical samples)."""
        from tpurt.kernels.mega_regen import render_regen
        scene = cornell_spheres_scene()
        cam = make_camera((0.0, 5.0, -12.0), (0.0, 5.0, 0.0), vfov=60.0,
                          aspect_ratio=2.0)
        cfg = RenderConfig(width=32, height=16, depth=3, backend="pallas",
                           pallas_lanes=512, k_photons=1,
                           max_photon_bounces=2)
        st_a = render_regen(scene, cfg, cam, init_state(cfg), 1234, 2)
        st_a = render_regen(scene, cfg, cam, st_a, 1234, 2)
        st_b = render_regen(scene, cfg, cam, init_state(cfg), 1234, 4)
        assert float(st_a.rays) == float(st_b.rays)
        np.testing.assert_array_equal(np.asarray(st_a.rgb_sum),
                                      np.asarray(st_b.rgb_sum))


class TestClusteredSweep:
    """Two-level AABB-culled sphere sweep (pallas_cluster_size) must be
    bit-identical to the flat static unroll: the cond-gated groups evaluate
    the same per-sphere math, culling only whole-tile no-ops."""

    def _render(self, cluster_size):
        from tpurt.scene import instanced_scene
        scene = instanced_scene(72)  # 73 spheres: clusters engage at 16
        cam = make_camera((0, 10, -14), (0, 1, 8), vfov=55.0,
                          aspect_ratio=2.0)
        cfg = RenderConfig(width=64, height=32, depth=3, backend="pallas",
                           pallas_lanes=512, pallas_static_unroll=128,
                           pallas_cluster_size=cluster_size,
                           k_photons=1, max_photon_bounces=2)
        return render(scene, cfg, cam, init_state(cfg), 99, 2), cfg

    def test_bit_identical_to_flat_sweep(self):
        st_c, cfg = self._render(16)
        st_f, _ = self._render(0)
        assert float(st_c.rays) == float(st_f.rays) != 0.0
        np.testing.assert_array_equal(np.asarray(st_c.rgb_sum),
                                      np.asarray(st_f.rgb_sum))

    def test_cull_tree_covers_all_spheres(self):
        from tpurt.kernels.mega_pallas import _sphere_cull_tree, freeze_scene
        from tpurt.scene import instanced_scene
        fs = freeze_scene(instanced_scene(72))
        tree = _sphere_cull_tree(fs.spheres, 16)

        leaves = []

        def walk(node, pmin, pmax):
            for c in range(3):  # child boxes nest inside the parent's
                assert node.bmin[c] >= pmin[c] - 1e-4
                assert node.bmax[c] <= pmax[c] + 1e-4
            if node.prims:
                assert not node.children
                assert len(node.prims) <= 16
                leaves.append(node)
                for sp in node.prims:  # leaf AABB bounds its spheres
                    for c in range(3):
                        assert node.bmin[c] <= sp.c[c] - sp.r + 1e-4
                        assert node.bmax[c] >= sp.c[c] + sp.r - 1e-4
            else:
                assert len(node.children) == 2
                for ch in node.children:
                    walk(ch, node.bmin, node.bmax)

        walk(tree.root, tree.root.bmin, tree.root.bmax)
        got = list(tree.always) + [sp for lf in leaves for sp in lf.prims]
        assert sorted(id(sp) for sp in got) == \
            sorted(id(sp) for sp in fs.spheres)

class TestClusteredTriangles:
    """Cull-tree triangle sweep must agree with the flat unroll (exact ray
    counts; values to float-fusion tolerance) and with the XLA integrator
    on ray counts."""

    @staticmethod
    def _grid_mesh_scene(n=5):
        from tpurt.scene import (Light, Material, MeshData, Sphere,
                                 build_scene)
        xs, zs = np.meshgrid(np.linspace(-4, 4, n), np.linspace(2, 10, n))
        ys = 0.6 * np.sin(xs) * np.cos(zs)
        pos = np.stack([xs, ys, zs], -1).reshape(-1, 3).astype(np.float32)
        idx = []
        for r in range(n - 1):
            for c in range(n - 1):
                a, b = r * n + c, r * n + c + 1
                cc, dd = (r + 1) * n + c, (r + 1) * n + c + 1
                idx += [[a, b, dd], [a, dd, cc]]
        mesh = MeshData(material_id=1)
        mesh.add_triangles(pos, np.asarray(idx, np.int32))
        mats = [Material.diffuse((0.7, 0.7, 0.7)),
                Material.diffuse((0.8, 0.3, 0.2))]
        sph = [Sphere(0, 1000.0, (0.0, -1001.0, 0.0))]
        lights = [Light.point([0.0, 8.0, 6.0], [1, 1, 1], 30.0, 5500.0)]
        return build_scene(mats, sph, [mesh], lights)

    def test_tree_matches_flat_and_xla(self):
        scene = self._grid_mesh_scene()  # 32 triangles
        w, h = 64, 32
        cam = make_camera((0, 6, -6), (0, 0, 6), vfov=60.0,
                          aspect_ratio=w / h)
        out = {}
        for name, kw in [
            ("tree", dict(backend="pallas", pallas_static_unroll=64,
                          pallas_cluster_size=4, pallas_lanes=512)),
            ("flat", dict(backend="pallas", pallas_static_unroll=64,
                          pallas_cluster_size=0, pallas_lanes=512)),
            ("xla", dict(backend="xla")),
        ]:
            cfg = RenderConfig(width=w, height=h, depth=3, k_photons=1,
                               max_photon_bounces=2, **kw)
            st = render(scene, cfg, cam, init_state(cfg), 42, 2)
            out[name] = (float(st.rays), np.asarray(st.rgb_sum)[:w * h])
        assert out["tree"][0] == out["flat"][0] == out["xla"][0] != 0.0
        np.testing.assert_allclose(out["tree"][1], out["flat"][1], atol=1e-4)

    def test_torus_mesh_scene_renders(self):
        """The 256-triangle procedural mesh scene (the mesh-at-scale demo)
        runs through the fused kernel with the triangle cull tree and
        matches the XLA integrator's exact ray count."""
        from tpurt import torus_mesh_scene
        scene = torus_mesh_scene()
        assert scene.num_triangles == 256
        cam = make_camera((0, 5.5, -2.5), (0, 1.0, 5.8), vfov=50.0,
                          aspect_ratio=2.0)
        kw = dict(width=48, height=24, depth=3, k_photons=1,
                  max_photon_bounces=2, pallas_lanes=512, tile_size=1152,
                  pallas_static_unroll=256, pallas_cluster_size=16)
        cfg_p = RenderConfig(backend="pallas", **kw)
        st_p = render(scene, cfg_p, cam, init_state(cfg_p), 5, 1)
        cfg_x = RenderConfig(backend="xla", **kw)
        st_x = render(scene, cfg_x, cam, init_state(cfg_x), 5, 1)
        assert float(st_p.rays) == float(st_x.rays) != 0.0
        img = np.asarray(st_p.rgb_sum)[:48 * 24]
        assert np.isfinite(img).all() and img.sum() > 0


class TestBoundedDrift:
    def test_drift_bound_bit_identical(self):
        """cfg.pallas_regen_drift is SCHEDULING only: bounding how far a
        lane runs ahead of its tile's slowest lane must not change a
        single bit of the accumulated state (same per-(pixel, sample)
        streams, same per-lane add order) — at the tightest bound (1)
        and a practical one (4), with the full strata stack live."""
        from tpurt import dispersive_scene
        scene = dispersive_scene()
        cam = make_camera((0, 3, -4), (0, 1, 5), vfov=55.0,
                          aspect_ratio=2.0)
        kw = dict(width=64, height=32, depth=4, tile_size=2048,
                  pallas_lanes=512, k_photons=2, max_photon_bounces=3,
                  backend="pallas", photon_strata=8, photon_strata_dir=64,
                  photon_strata_window=4, photon_strata_shared_k=True,
                  photon_strata_bounce=True, camera_strata_bounce=True)
        cfg0 = RenderConfig(**kw)
        st0 = render(scene, cfg0, cam, init_state(cfg0), 7, 6)
        assert float(st0.rays) != 0.0
        for w in (1, 4):
            cfgw = RenderConfig(pallas_regen_drift=w, **kw)
            stw = render(scene, cfgw, cam, init_state(cfgw), 7, 6)
            assert float(stw.rays) == float(st0.rays)
            assert np.array_equal(np.asarray(stw.rgb_sum),
                                  np.asarray(st0.rgb_sum)), w
