"""ops/qmc.py oracle tests: Sobol construction vs torch's SobolEngine,
Owen-scramble stratification invariants, stream dispatch."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpurt.ops import qmc
from tpurt.ops import rng as rngmod


def _points(n, dim, scramble_seed=None):
    idx = jnp.arange(n, dtype=jnp.uint32)
    bits = qmc.sobol_u32(idx, dim)
    if scramble_seed is not None:
        bits = qmc.owen_scramble_u32(bits, jnp.uint32(scramble_seed))
    return np.asarray(bits).astype(np.uint64) / 2.0**32


def test_sobol_matches_torch():
    """The direction-number construction reproduces torch's Joe-Kuo Sobol
    (first 128 points, all 6 dims). torch enumerates in Gray-code order:
    its point i is the natural-order point gray(i) = i ^ (i >> 1)."""
    torch = pytest.importorskip("torch")
    ref = torch.quasirandom.SobolEngine(qmc.N_DIMS, scramble=False)
    want = ref.draw(128, dtype=torch.float64).numpy()
    i = np.arange(128, dtype=np.uint32)
    gray = jnp.asarray(i ^ (i >> 1), jnp.uint32)
    got = np.stack(
        [np.asarray(qmc.sobol_u32(gray, d)).astype(np.uint64) / 2.0**32
         for d in range(qmc.N_DIMS)], axis=1)
    np.testing.assert_allclose(got, want, atol=1e-9)


@pytest.mark.parametrize("dim", range(qmc.N_DIMS))
@pytest.mark.parametrize("seed", [0, 1, 0xDEADBEEF])
def test_owen_preserves_1d_stratification(dim, seed):
    """First 2^m scrambled points hit each of 2^m equal bins exactly once
    (the elementary-interval property Owen scrambling must preserve)."""
    for m in (1, 3, 6):
        pts = _points(1 << m, dim, scramble_seed=seed)
        bins = np.floor(pts * (1 << m)).astype(int)
        assert sorted(bins) == list(range(1 << m)), (dim, m, seed)


def test_owen_preserves_2d_net():
    """Dims (0,1) form a (0,2)-sequence: the first 4^m points hit every
    cell of a 2^m x 2^m grid exactly once, independent scrambles on each
    axis preserve it."""
    m = 3
    n = 4**m
    x = np.floor(_points(n, 0, scramble_seed=7) * (1 << m)).astype(int)
    y = np.floor(_points(n, 1, scramble_seed=99) * (1 << m)).astype(int)
    cells = set(zip(x.tolist(), y.tolist()))
    assert len(cells) == n


def test_owen_scramble_is_uniform_bijection():
    """The scramble permutes a dyadic prefix set onto itself (bijection on
    u32 => distinct inputs stay distinct) and different seeds give
    different permutations."""
    bits = jnp.arange(4096, dtype=jnp.uint32) << jnp.uint32(20)
    a = np.asarray(qmc.owen_scramble_u32(bits, jnp.uint32(1)))
    b = np.asarray(qmc.owen_scramble_u32(bits, jnp.uint32(2)))
    assert len(np.unique(a)) == 4096
    assert (a != b).any()


def test_stream_dispatch_and_dims():
    """rngmod.rand_1f/rand_2f dispatch on QmcStream; each draw consumes one
    Sobol dimension; the pixel jitter pair differs across pixels but the
    underlying point set (pre-scramble) is shared."""
    px = jnp.array([3, 4, 3], jnp.int32)
    py = jnp.array([5, 5, 9], jnp.int32)
    st = qmc.spawn_stream(123, 17, px, py)
    u2, st = rngmod.rand_2f(st)
    assert st.dim == 2
    u3, st = rngmod.rand_1f(st)
    assert st.dim == 3
    assert u2.shape == (3, 2) and u3.shape == (3,)
    vals = np.asarray(u2)
    assert (vals >= 0).all() and (vals <= 1.0).all()
    # per-pixel scrambles decorrelate
    assert not np.allclose(vals[0], vals[1])
    assert not np.allclose(vals[0], vals[2])


def test_stream_is_pure_function_of_sample():
    """Same (base_seed, pixel, sample) => identical draws (the cross-
    backend pairing contract); different samples/seeds differ."""
    px = jnp.array([10], jnp.int32)
    py = jnp.array([20], jnp.int32)

    def draws(seed, samp):
        st = qmc.spawn_stream(seed, samp, px, py)
        out = []
        for _ in range(qmc.N_DIMS):
            u, st = rngmod.rand_1f(st)
            out.append(float(u[0]))
        return out

    assert draws(1, 5) == draws(1, 5)
    assert draws(1, 5) != draws(1, 6)
    assert draws(1, 5) != draws(2, 5)


def test_stream_exhaustion_raises():
    st = qmc.spawn_stream(0, 0, jnp.array([0], jnp.int32),
                          jnp.array([0], jnp.int32))
    for _ in range(qmc.N_DIMS):
        _, st = rngmod.rand_1f(st)
    with pytest.raises(ValueError, match="exhausted"):
        rngmod.rand_1f(st)


def test_per_pixel_sequence_stratified():
    """A single pixel's scrambled jitter sequence stays stratified: 16
    consecutive samples of dim 0 land one per 1/16 bin."""
    px = jnp.array([7], jnp.int32)
    py = jnp.array([11], jnp.int32)
    us = []
    for s in range(16):
        st = qmc.spawn_stream(42, s, px, py)
        u, _ = rngmod.rand_1f(st)
        us.append(float(u[0]))
    bins = sorted(int(u * 16) for u in us)
    assert bins == list(range(16))


# ----- integration: the cfg.qmc flag through the renderers -----

from tpurt import (RenderConfig, cornell_spheres_scene, make_camera, render,
                   init_state, resolve_image)


def _setup(backend="xla", **kw):
    cfg = RenderConfig(width=64, height=32, depth=4, backend=backend,
                       enable_photons=False, qmc=True, **kw)
    scene = cornell_spheres_scene()
    cam = make_camera((0., 5., -12.), (0., 5., 0.), vfov=60.0,
                      aspect_ratio=2.0)
    return cfg, scene, cam


class TestQmcRender:
    def test_image_finite_and_differs_from_pcg(self):
        cfg, scene, cam = _setup()
        st_q = render(scene, cfg, cam, init_state(cfg), 9, 4)
        st_p = render(scene, cfg.with_(qmc=False), cam, init_state(cfg), 9, 4)
        img = np.asarray(resolve_image(cfg, st_q))
        assert np.isfinite(img).all() and img.max() > 0
        assert np.abs(np.asarray(st_q.rgb_sum)
                      - np.asarray(st_p.rgb_sum)).max() > 1e-3

    def test_progressive_continuation_bit_exact(self):
        """One 4-spp call == two 2-spp calls: the Sobol index is the
        GLOBAL sample number carried in state.iteration."""
        cfg, scene, cam = _setup()
        st_a = render(scene, cfg, cam, init_state(cfg), 9, 4)
        st_b = render(scene, cfg, cam, init_state(cfg), 9, 2)
        st_b = render(scene, cfg, cam, st_b, 9, 2)
        assert (np.asarray(st_a.rgb_sum) == np.asarray(st_b.rgb_sum)).all()
        assert float(st_a.rays) == float(st_b.rays) != 0.0

    def test_qmc_with_photons_runs(self):
        cfg, scene, cam = _setup()
        cfg = cfg.with_(enable_photons=True, depth=3)
        st = render(scene, cfg, cam, init_state(cfg), 9, 2)
        assert np.isfinite(np.asarray(st.rgb_sum)).all()
        assert float(st.rays) > 0

    @pytest.mark.slow
    def test_qmc_reduces_mse(self):
        """The point of the flag: at equal spp the Sobol spawn converges
        measurably closer to the converged image (fixed seeds, generous
        margin — the measured gap on this scene is ~2x at 16 spp)."""
        cfg, scene, cam = _setup()
        cfg = cfg.with_(enable_photons=True, depth=8)
        n = cfg.n_pixels

        def raw(st):
            return (np.asarray(st.rgb_sum, np.float64)[:n]
                    / np.maximum(np.asarray(st.n_samples,
                                            np.float64)[:n, None], 1))

        gt = raw(render(scene, cfg.with_(qmc=False), cam, init_state(cfg),
                        999331, 512))

        def mse(c):
            e = []
            for rep in range(3):
                st = render(scene, c, cam, init_state(c), 1000 + 7919 * rep, 16)
                e.append(((raw(st) - gt) ** 2).mean())
            return float(np.mean(e))

        m_q, m_p = mse(cfg), mse(cfg.with_(qmc=False))
        assert m_q < 0.75 * m_p, (m_q, m_p)


@pytest.mark.slow
class TestQmcBackends:
    def test_cross_backend_exact_rays(self):
        """With qmc on (and DOF exercising the lens dims) every backend
        draws identical spawn + path streams: exact ray parity, images
        agree except rare reassociation branch flips."""
        kw = dict(aperture=0.5, focus_dist=12.0)
        cfg, scene, cam = _setup(**kw)
        st_x = render(scene, cfg, cam, init_state(cfg), 9, 4)

        sts = []
        for backend, extra in (("pallas", {}),):
            cfg_b, _, _ = _setup(backend=backend, pallas_lanes=512,
                                 **kw, **extra)
            sts.append(render(scene, cfg_b, cam, init_state(cfg_b), 9, 4))

        n = cfg.n_pixels
        for st_o in sts:
            assert float(st_x.rays) == float(st_o.rays) != 0.0
            a = np.asarray(st_x.rgb_sum)[:n]
            b = np.asarray(st_o.rgb_sum)[:n]
            assert (np.abs(a - b).max(axis=-1) > 1e-2).mean() < 0.02

    def test_wavefront_pool_exact_rays(self):
        """The XLA pool tracer spawns through _issue: same qmc pairing."""
        cfg, scene, cam = _setup()
        st_x = render(scene, cfg, cam, init_state(cfg), 9, 4)
        cfg_w, _, _ = _setup(backend="wavefront", wf_pool=4096)
        st_w = render(scene, cfg_w, cam, init_state(cfg_w), 9, 4)
        assert float(st_x.rays) == float(st_w.rays) != 0.0

    def test_motion_blur_all_dims(self):
        """motion + lens + qmc consumes all 6 Sobol dims; XLA and the
        regen kernel stay exactly ray-paired."""
        from tpurt.camera import MotionCamera
        kw = dict(aperture=0.4, focus_dist=12.0, motion_blur=True)
        cfg, scene, _ = _setup(**kw)
        cam0 = make_camera((0., 5., -12.), (0., 5., 0.), vfov=60.0,
                           aspect_ratio=2.0)
        cam1 = make_camera((0.4, 5.2, -11.8), (0., 5., 0.), vfov=60.0,
                           aspect_ratio=2.0)
        mc = MotionCamera(cam0, cam1)
        st_x = render(scene, cfg, mc, init_state(cfg), 9, 4)
        cfg_p, _, _ = _setup(backend="pallas", pallas_lanes=512, **kw)
        st_p = render(scene, cfg_p, mc, init_state(cfg_p), 9, 4)
        assert float(st_x.rays) == float(st_p.rays) != 0.0
