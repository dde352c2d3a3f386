"""Tile-coherent stratified photon emission (cfg.photon_strata, EXTENSION).

The stratum is a pure function of (frame seed, k) shared by every pixel and
every backend (ops/rng.emission_strata), so the flag must preserve the
cross-backend exactness contract; across samples the hash-uniform stratum
choice keeps the emission distribution exactly that of the reference
sampler, so the converged image must agree within MC noise.
"""

import numpy as np

from tpurt import (RenderConfig, cornell_spheres_scene, init_state,
                   make_camera, render, resolve_image)
from tpurt.ops import rng as rngmod


def _cam():
    return make_camera((0.0, 5.0, -12.0), (0.0, 5.0, 0.0), vfov=60.0,
                       aspect_ratio=2.0)


def test_strata_indices_pure_and_in_range():
    import jax.numpy as jnp
    s = jnp.uint32(12345)
    a = rngmod.emission_strata(s, 2, 8, 8)
    b = rngmod.emission_strata(s, 2, 8, 8)
    for x, y in zip(a, b):
        assert float(x) == float(y)
        assert 0.0 <= float(x) <= 7.0
    # different k -> (almost surely) different cell
    c = rngmod.emission_strata(s, 3, 8, 8)
    assert any(float(x) != float(y) for x, y in zip(a, c))
    # decoupled direction count: position fields in [0, 4), dir in [0, 256)
    pu, pv, da, db = rngmod.emission_strata(s, 2, 4, 256)
    assert 0.0 <= float(pu) <= 3.0 and 0.0 <= float(pv) <= 3.0
    assert 0.0 <= float(da) <= 255.0 and 0.0 <= float(db) <= 255.0
    # dir=0 config means "same as photon_strata"
    cfg = RenderConfig(photon_strata=16)
    assert rngmod.strata_counts(cfg) == (16, 16)
    assert rngmod.strata_counts(cfg.with_(photon_strata_dir=64)) == (16, 64)


def test_xla_kernel_parity_with_strata():
    """XLA vs regen with the flag on: the same contract as flag-off
    (exact counts on this config, tiny divergent-pixel fraction).
    dispersive_scene has a POINT light too, exercising the cone remap."""
    from tpurt import dispersive_scene
    for scene, cam in ((cornell_spheres_scene(), _cam()),
                       (dispersive_scene(),
                        make_camera((0.0, 3.0, -4.0), (0.0, 1.0, 5.0),
                                    vfov=55.0, aspect_ratio=2.0))):
        kw = dict(width=64, height=32, depth=3, tile_size=2048,
                  pallas_lanes=512, k_photons=2, max_photon_bounces=2,
                  photon_strata=8)
        cfg_x = RenderConfig(backend="xla", **kw)
        cfg_p = RenderConfig(backend="pallas", **kw)
        st_x = render(scene, cfg_x, cam, init_state(cfg_x), 5, 2)
        st_p = render(scene, cfg_p, cam, init_state(cfg_p), 5, 2)
        assert float(st_x.rays) == float(st_p.rays) != 0.0
        img_x = np.asarray(resolve_image(cfg_x, st_x))
        img_p = np.asarray(resolve_image(cfg_p, st_p))
        assert ((np.abs(img_x - img_p) > 1e-4).any(axis=-1)).mean() < 0.03


def test_strata_unbiased_vs_reference_sampler():
    """Means agree within MC noise of the photon share: strata change
    WHICH photons a sample draws, never their distribution."""
    scene = cornell_spheres_scene()
    kw = dict(width=48, height=24, depth=4, pallas_lanes=512,
              k_photons=2, max_photon_bounces=3)
    cfg_s = RenderConfig(backend="pallas", photon_strata=8, **kw)
    cfg_r = RenderConfig(backend="pallas", **kw)
    st_s = render(scene, cfg_s, _cam(), init_state(cfg_s), 1234, 32)
    st_r = render(scene, cfg_r, _cam(), init_state(cfg_r), 1234, 32)
    m_s = float(np.asarray(st_s.rgb_sum).mean())
    m_r = float(np.asarray(st_r.rgb_sum).mean())
    assert abs(m_s - m_r) < 5e-3 * max(m_r, 1e-6), (m_s, m_r)


def test_dir_strata_parity_and_unbiased():
    """photon_strata_dir decouples the direction cells: cross-backend
    exactness and sampler unbiasedness both hold at (pos=8, dir=64)."""
    from tpurt import dispersive_scene
    scene = dispersive_scene()   # area + point light: cone remap covered
    cam = make_camera((0.0, 3.0, -4.0), (0.0, 1.0, 5.0), vfov=55.0,
                      aspect_ratio=2.0)
    kw = dict(width=64, height=32, depth=3, tile_size=2048,
              pallas_lanes=512, k_photons=2, max_photon_bounces=2,
              photon_strata=8, photon_strata_dir=64)
    cfg_x = RenderConfig(backend="xla", **kw)
    cfg_p = RenderConfig(backend="pallas", **kw)
    st_x = render(scene, cfg_x, cam, init_state(cfg_x), 5, 2)
    st_p = render(scene, cfg_p, cam, init_state(cfg_p), 5, 2)
    assert float(st_x.rays) == float(st_p.rays) != 0.0
    img_x = np.asarray(resolve_image(cfg_x, st_x))
    img_p = np.asarray(resolve_image(cfg_p, st_p))
    assert ((np.abs(img_x - img_p) > 1e-4).any(axis=-1)).mean() < 0.03

    # unbiasedness at fine dir strata vs the reference sampler
    scene2 = cornell_spheres_scene()
    kw2 = dict(width=48, height=24, depth=4, pallas_lanes=512,
               k_photons=2, max_photon_bounces=3)
    cfg_s = RenderConfig(backend="pallas", photon_strata=8,
                         photon_strata_dir=64, **kw2)
    cfg_r = RenderConfig(backend="pallas", **kw2)
    st_s = render(scene2, cfg_s, _cam(), init_state(cfg_s), 1234, 32)
    st_r = render(scene2, cfg_r, _cam(), init_state(cfg_r), 1234, 32)
    m_s = float(np.asarray(st_s.rgb_sum).mean())
    m_r = float(np.asarray(st_r.rgb_sum).mean())
    assert abs(m_s - m_r) < 8e-3 * max(m_r, 1e-6), (m_s, m_r)


def test_window_strata_parity_and_unbiased():
    """photon_strata_window: consecutive samples share a cell epoch.  The
    epoch is a function of the GLOBAL sample index, so both backends
    still compute identical strata (exact ray counts) and the sampler mean
    is unchanged within (inflated) MC noise."""
    scene = cornell_spheres_scene()
    kw = dict(width=64, height=32, depth=3, tile_size=2048,
              pallas_lanes=512, k_photons=2, max_photon_bounces=2,
              photon_strata=8, photon_strata_dir=64,
              photon_strata_shared_k=True, photon_strata_window=4)
    cfg_x = RenderConfig(backend="xla", **kw)
    cfg_p = RenderConfig(backend="pallas", **kw)
    st_x = render(scene, cfg_x, _cam(), init_state(cfg_x), 5, 6)
    st_p = render(scene, cfg_p, _cam(), init_state(cfg_p), 5, 6)
    # XLA-vs-Pallas is ulp-close, not bit-exact: at spp >= ~3 a branch
    # flip (RR compare on an ulp-different throughput) shifts a count by
    # ~1 (measured: +1 at spp 6 even with photon_strata=0).  1e-5
    # relative, the contract chip_smoke.py holds the kernel to.
    rx = float(st_x.rays)
    assert rx != 0.0
    assert abs(float(st_p.rays) - rx) <= max(1e-5 * rx, 2.0)
    img_x = np.asarray(resolve_image(cfg_x, st_x))
    img_p = np.asarray(resolve_image(cfg_p, st_p))
    # 0.05 (not the spp-2 tests' 0.03): flip pixels accumulate per sample,
    # and this test runs 6 samples (measured 3.1% at spp 6)
    assert ((np.abs(img_x - img_p) > 1e-4).any(axis=-1)).mean() < 0.05

    # windowed continuation must equal one long call (epochs follow the
    # global sample index, not the call boundary)
    st_a = render(scene, cfg_p, _cam(), init_state(cfg_p), 5, 3)
    st_a = render(scene, cfg_p, _cam(), st_a, 5, 3)
    np.testing.assert_array_equal(np.asarray(st_a.rgb_sum),
                                  np.asarray(st_p.rgb_sum))

    kw2 = dict(width=48, height=24, depth=4, pallas_lanes=512,
               k_photons=2, max_photon_bounces=3)
    cfg_s = RenderConfig(backend="pallas", photon_strata=8,
                         photon_strata_dir=64, photon_strata_shared_k=True,
                         photon_strata_window=4, **kw2)
    cfg_r = RenderConfig(backend="pallas", **kw2)
    st_s = render(scene, cfg_s, _cam(), init_state(cfg_s), 1234, 64)
    st_r = render(scene, cfg_r, _cam(), init_state(cfg_r), 1234, 64)
    m_s = float(np.asarray(st_s.rgb_sum).mean())
    m_r = float(np.asarray(st_r.rgb_sum).mean())
    assert abs(m_s - m_r) < 2e-2 * max(m_r, 1e-6), (m_s, m_r)


def test_shared_k_strata_parity_and_unbiased():
    """photon_strata_shared_k folds all K photons of a sample into one
    cell: cross-backend exactness holds, and the sampler stays unbiased
    (k-correlation raises variance, never the mean)."""
    scene = cornell_spheres_scene()
    kw = dict(width=64, height=32, depth=3, tile_size=2048,
              pallas_lanes=512, k_photons=4, max_photon_bounces=2,
              photon_strata=8, photon_strata_dir=64,
              photon_strata_shared_k=True)
    cfg_x = RenderConfig(backend="xla", **kw)
    cfg_p = RenderConfig(backend="pallas", **kw)
    st_x = render(scene, cfg_x, _cam(), init_state(cfg_x), 5, 2)
    st_p = render(scene, cfg_p, _cam(), init_state(cfg_p), 5, 2)
    assert float(st_x.rays) == float(st_p.rays) != 0.0
    img_x = np.asarray(resolve_image(cfg_x, st_x))
    img_p = np.asarray(resolve_image(cfg_p, st_p))
    assert ((np.abs(img_x - img_p) > 1e-4).any(axis=-1)).mean() < 0.03

    kw2 = dict(width=48, height=24, depth=4, pallas_lanes=512,
               k_photons=4, max_photon_bounces=3)
    cfg_s = RenderConfig(backend="pallas", photon_strata=8,
                         photon_strata_dir=64,
                         photon_strata_shared_k=True, **kw2)
    cfg_r = RenderConfig(backend="pallas", **kw2)
    st_s = render(scene, cfg_s, _cam(), init_state(cfg_s), 1234, 48)
    st_r = render(scene, cfg_r, _cam(), init_state(cfg_r), 1234, 48)
    m_s = float(np.asarray(st_s.rgb_sum).mean())
    m_r = float(np.asarray(st_r.rgb_sum).mean())
    assert abs(m_s - m_r) < 1.2e-2 * max(m_r, 1e-6), (m_s, m_r)


def test_bounce_strata_parity_and_unbiased():
    """photon_strata_bounce remaps each photon BOUNCE's scatter uniforms
    into a tile-shared (sample, k, bounce) cell: draw positions unchanged
    (ray counts within the flip contract), cross-backend agreement within
    the flip-pixel bound, and the sampler mean unchanged within MC noise
    (the cell is hash-uniform per sample; the remap is measure-preserving
    and independent of every lane's own draws)."""
    import jax.numpy as jnp

    # helper purity + range + [0,1) closure
    s = jnp.uint32(999)
    a = rngmod.apply_bounce_strata(s, 1, 2, 64, jnp.float32(0.999999),
                                   jnp.float32(0.0), jnp.float32(0.5))
    b = rngmod.apply_bounce_strata(s, 1, 2, 64, jnp.float32(0.999999),
                                   jnp.float32(0.0), jnp.float32(0.5))
    for x, y in zip(a, b):
        assert float(x) == float(y) and 0.0 <= float(x) < 1.0
    c = rngmod.apply_bounce_strata(s, 1, 3, 64, jnp.float32(0.999999),
                                   jnp.float32(0.0), jnp.float32(0.5))
    assert any(float(x) != float(y) for x, y in zip(a, c))

    scene = cornell_spheres_scene()
    kw = dict(width=64, height=32, depth=3, tile_size=2048,
              pallas_lanes=512, k_photons=2, max_photon_bounces=3,
              photon_strata=8, photon_strata_dir=64,
              photon_strata_shared_k=True, photon_strata_bounce=True)
    cfg_x = RenderConfig(backend="xla", **kw)
    cfg_p = RenderConfig(backend="pallas", **kw)
    st_x = render(scene, cfg_x, _cam(), init_state(cfg_x), 5, 3)
    st_p = render(scene, cfg_p, _cam(), init_state(cfg_p), 5, 3)
    rx = float(st_x.rays)
    assert rx != 0.0
    assert abs(float(st_p.rays) - rx) <= max(1e-5 * rx, 2.0)
    img_x = np.asarray(resolve_image(cfg_x, st_x))
    img_p = np.asarray(resolve_image(cfg_p, st_p))
    assert ((np.abs(img_x - img_p) > 1e-4).any(axis=-1)).mean() < 0.03

    kw2 = dict(width=48, height=24, depth=4, pallas_lanes=512,
               k_photons=2, max_photon_bounces=3)
    cfg_s = RenderConfig(backend="pallas", photon_strata=8,
                         photon_strata_dir=64, photon_strata_shared_k=True,
                         photon_strata_bounce=True, **kw2)
    cfg_r = RenderConfig(backend="pallas", **kw2)
    st_s = render(scene, cfg_s, _cam(), init_state(cfg_s), 1234, 64)
    st_r = render(scene, cfg_r, _cam(), init_state(cfg_r), 1234, 64)
    m_s = float(np.asarray(st_s.rgb_sum).mean())
    m_r = float(np.asarray(st_r.rgb_sum).mean())
    assert abs(m_s - m_r) < 2e-2 * max(m_r, 1e-6), (m_s, m_r)


def test_camera_bounce_strata_parity_and_unbiased():
    """camera_strata_bounce: tile-shared (sample, bounce) cells for the
    CAMERA path's scatter uniforms (key disjoint from photon cells).
    Same contracts: draw positions unchanged, cross-backend agreement,
    sampler mean unchanged within MC noise."""
    scene = cornell_spheres_scene()
    kw = dict(width=64, height=32, depth=4, tile_size=2048,
              pallas_lanes=512, k_photons=2, max_photon_bounces=2,
              photon_strata=8, photon_strata_dir=64,
              camera_strata_bounce=True)
    cfg_x = RenderConfig(backend="xla", **kw)
    cfg_p = RenderConfig(backend="pallas", **kw)
    st_x = render(scene, cfg_x, _cam(), init_state(cfg_x), 5, 3)
    st_p = render(scene, cfg_p, _cam(), init_state(cfg_p), 5, 3)
    rx = float(st_x.rays)
    assert rx != 0.0
    assert abs(float(st_p.rays) - rx) <= max(1e-5 * rx, 2.0)
    img_x = np.asarray(resolve_image(cfg_x, st_x))
    img_p = np.asarray(resolve_image(cfg_p, st_p))
    # 0.06: depth-4 camera paths accumulate more RR/branch flips per
    # pixel than the depth-3 photon-strata tests (measured 3.8%)
    assert ((np.abs(img_x - img_p) > 1e-4).any(axis=-1)).mean() < 0.06

    kw2 = dict(width=48, height=24, depth=4, pallas_lanes=512,
               k_photons=2, max_photon_bounces=3)
    cfg_s = RenderConfig(backend="pallas", photon_strata=8,
                         photon_strata_dir=64, camera_strata_bounce=True,
                         photon_strata_bounce=True,
                         photon_strata_shared_k=True, **kw2)
    cfg_r = RenderConfig(backend="pallas", **kw2)
    st_s = render(scene, cfg_s, _cam(), init_state(cfg_s), 1234, 64)
    st_r = render(scene, cfg_r, _cam(), init_state(cfg_r), 1234, 64)
    m_s = float(np.asarray(st_s.rgb_sum).mean())
    m_r = float(np.asarray(st_r.rgb_sum).mean())
    assert abs(m_s - m_r) < 2e-2 * max(m_r, 1e-6), (m_s, m_r)


def test_wide_dir_strata():
    """Direction cells past 256 (two 16-bit fields from a second PCG
    word): the <=256 layout is pinned bit-identical (goldens), wide
    fields are in range, remapped uniforms stay in [0, 1), and the
    caps reject out-of-range counts."""
    import jax.numpy as jnp
    import pytest

    s = jnp.uint32(12345)
    # goldens pin the narrow layout (any drift breaks cross-round repro)
    assert [float(x) for x in rngmod.emission_strata(s, 2, 8, 8)] \
        == [7.0, 4.0, 0.0, 1.0]
    assert [float(x) for x in rngmod.emission_strata(s, 2, 4, 256)] \
        == [3.0, 0.0, 48.0, 201.0]
    # wide path: position fields identical, dir fields from the 2nd word
    pu, pv, da, db = rngmod.emission_strata(s, 2, 4, 1024)
    assert (float(pu), float(pv)) == (3.0, 0.0)
    assert 0.0 <= float(da) <= 1023.0 and 0.0 <= float(db) <= 1023.0
    assert [float(da), float(db)] == [642.0, 978.0]  # golden
    # purity + k-sensitivity hold in the wide regime too
    again = rngmod.emission_strata(s, 2, 4, 1024)
    assert [float(x) for x in again] == [3.0, 0.0, 642.0, 978.0]
    other_k = rngmod.emission_strata(s, 3, 4, 1024)
    assert any(float(x) != float(y) for x, y in zip(again, other_k))

    # remapped uniforms stay inside [0, 1) at the finest count
    us = tuple(jnp.float32(u) for u in
               (0.999999, 0.5, 0.0, 0.25, 0.75, 0.125))
    out = rngmod.apply_emission_strata(s, 2, 16, 4096, *us)
    for u in out:
        assert 0.0 <= float(u) < 1.0
    ba, bb, bc = rngmod.apply_bounce_strata(
        s, 1, 2, 1024, jnp.float32(0.5), jnp.float32(0.25),
        jnp.float32(0.75))
    for u in (ba, bb, bc):
        assert 0.0 <= float(u) < 1.0
    # narrow bounce layout pinned too
    g = rngmod.apply_bounce_strata(s, 1, 2, 64, jnp.float32(0.5),
                                   jnp.float32(0.25), jnp.float32(0.75))
    assert [float(x) for x in g] == [0.3515625, 0.25390625, 0.02734375]

    with pytest.raises(ValueError):
        rngmod.emission_strata(s, 2, 8, 8192)   # dir cap
    with pytest.raises(ValueError):
        rngmod.emission_strata(s, 2, 512, 8)    # pos stays narrow
