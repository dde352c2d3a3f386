"""The fused kernel's plane state resolves to the same image as the
RenderState it came from: the plane-order permutation is exact and the
resolve + tonemap is the plain jnp blit (ref: blit.wgsl:28-40)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from tpurt import RenderConfig
from tpurt.kernels.mega_pallas import state_to_planes
from tpurt.parallel.sharding import planes_to_state, resolve_planes
from tpurt.render import init_state, resolve_image


def _random_state(cfg, n_samples):
    st = init_state(cfg)
    rng = np.random.default_rng(3)
    P = st.rgb_sum.shape[0]

    def f(*shape):
        # negative sums too: single-wavelength samples are out of gamut
        return jnp.asarray(rng.normal(size=shape).astype(np.float32))
    return dataclasses.replace(
        st, rgb_sum=f(P, 3) * n_samples, vis_pos=f(P, 3), vis_norm=f(P, 3),
        vis_wo=f(P, 3), vis_tp=f(P, 3),
        vis_mat=jnp.asarray(rng.integers(0, 4, P), jnp.int32),
        n_samples=jnp.full((P,), n_samples, jnp.float32))


def test_resolve_planes_matches_resolve_image():
    cfg = RenderConfig(width=200, height=40, backend="pallas",
                       pallas_lanes=256)
    st = _random_state(cfg, 4.0)
    ref = np.asarray(resolve_image(cfg, st))
    out = resolve_planes(cfg, state_to_planes(st, cfg), 4)
    assert out.shape == (40, 200, 3)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("block_tiles", [True, False])
def test_planes_round_trip_exact(block_tiles):
    cfg = RenderConfig(width=200, height=40, backend="pallas",
                       pallas_lanes=256, pallas_block_tiles=block_tiles)
    st = _random_state(cfg, 2.0)
    back = planes_to_state(cfg, state_to_planes(st, cfg), 2, 1.5, 7.0)
    n = cfg.n_pixels
    for name in ("rgb_sum", "vis_pos", "vis_norm", "vis_wo", "vis_tp",
                 "vis_mat", "n_samples"):
        np.testing.assert_array_equal(np.asarray(getattr(back, name))[:n],
                                      np.asarray(getattr(st, name))[:n])
    assert float(back.photon_radius) == 1.5 and float(back.rays) == 7.0
