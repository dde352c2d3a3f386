"""Variance-adaptive sampling over the wavefront pool (extension).

The reference renders a uniform sample count per pixel (its progressive loop
adds 1 spp/frame everywhere, ref: src/mega_kernel.rs:186-198); it has no
adaptive sampler. This module is a beyond-reference extension that leans on
two properties of the tpurt design:

  * the persistent wavefront pool consumes an *arbitrary* (pixel, sample)
    work stream at ~100% occupancy (tpurt/wavefront.py) — nonuniform
    per-pixel budgets cost nothing extra because the pool shape is static
    regardless of the budget map;
  * pixel p's k-th sample draws from a PCG stream keyed only by (p, k)
    (render._frame_seed + rng.seed_pixels), so per-pixel estimates are
    unbiased under ANY budget map and the accumulated state stays resolvable
    by the standard per-pixel-count blit (blit.wgsl:38 semantics).

``wavefront_render_budget`` renders ``budgets[p]`` further samples for every
pixel p, enumerating work round-major (one sample per still-hungry pixel per
round, pixels in stable descending-budget order). With a uniform budget this
is *the same flat enumeration* as ``wavefront_render`` — same issue order,
same pool schedule — so the uniform case is bit-identical to the uniform
tracer (pinned in tests/test_adaptive.py).

``render_adaptive`` is the driver: two half-pilot passes, a per-pixel
variance proxy from their disagreement, then one budget drain that spends
the remaining ray budget where the image is still noisy.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from tpurt.camera import Camera
from tpurt.config import RenderConfig
from tpurt.render import RenderState, init_state
from tpurt.scene import Scene
from tpurt.tonemap import LUMA
from tpurt.wavefront import (
    WavefrontPool,
    _issue,
    _sweep,
    reject_camera_strata,
    wavefront_render,
)


def _round_major_tables(budgets, max_budget: int):
    """Tables for the round-major work enumeration.

    Work item w (flat, 0-based) maps to (round s, pixel order[r]):
      round sizes   c[s]   = #pixels with budget > s          (s < max_budget)
      boundaries    cum[s] = c[0] + ... + c[s]
      s  = first index with cum[s] > w      (searchsorted right)
      r  = w - cum[s-1]                     (rank within the round)
    ``order`` lists pixels in stable descending-budget order, so every round
    visits exactly the pixels whose budget exceeds its index, in pixel-id
    order within equal budgets. Uniform budgets reduce this to the
    sample-major (sample, pixel) enumeration of wavefront._regen.
    """
    P = budgets.shape[0]
    counts = jnp.zeros((max_budget + 1,), jnp.int32).at[budgets].add(1)
    le = jnp.cumsum(counts)                      # #pixels with budget <= s
    c = jnp.int32(P) - le[:max_budget]           # #pixels with budget >  s
    cum = jnp.cumsum(c)                          # (max_budget,)
    order = jnp.argsort(-budgets, stable=True).astype(jnp.int32)
    total = cum[max_budget - 1]
    return order, cum, total


def _regen_budget(cfg: RenderConfig, camera: Camera, pool: WavefrontPool,
                  next_work, base_seed, base_counts, order, cum, total,
                  pix_offset):
    """Refill dead slots from the round-major budgeted work stream.

    ``base_counts[p]`` is the pixel's progressive sample index to continue
    from (its accumulated n_samples), so repeated budget calls draw fresh
    samples exactly like the uniform tracer's iteration carry. ``pix`` is
    the state-row index; the global pixel coordinate adds ``pix_offset``
    (nonzero only under slab sharding)."""
    dead = ~pool.active
    rank = jnp.cumsum(dead.astype(jnp.int32)) - 1
    w = next_work + rank
    s = jnp.searchsorted(cum, w, side="right").astype(jnp.int32)
    s_safe = jnp.minimum(s, cum.shape[0] - 1)
    start = jnp.where(s > 0, cum[jnp.maximum(s_safe - 1, 0)], 0)
    r = w - start
    have_work = dead & (w < total)
    pix = order[jnp.clip(r, 0, order.shape[0] - 1)]
    sample_it = base_counts[pix] + s_safe

    new_pool = _issue(cfg, camera, pool, pix, pix_offset + pix, sample_it,
                      have_work, base_seed)
    issued = jnp.sum(have_work.astype(jnp.int32))
    return new_pool, next_work + issued


@functools.partial(jax.jit, static_argnames=("cfg", "max_budget"))
def wavefront_render_budget(scene, cfg: RenderConfig, camera: Camera,
                            state: RenderState, base_seed, budgets,
                            max_budget: int) -> RenderState:
    """Render ``budgets[p]`` additional samples for every pixel p.

    ``budgets`` is (padded_pixels,) i32 — pad-row entries must be 0 — with
    every entry in [0, max_budget] (clipped). ``max_budget`` is static (it
    sizes the round table); the summed budget must stay below 2**31 (the
    driver asserts the bound). Accumulates into the same RenderState as
    every other backend; vispoints/photon state untouched (camera+NEE only,
    like the uniform wavefront tracers)."""
    return wavefront_render_budget_slab(scene, cfg, camera, state,
                                        base_seed, budgets, max_budget,
                                        jnp.int32(0))


def wavefront_render_budget_slab(scene, cfg: RenderConfig, camera: Camera,
                                 state: RenderState, base_seed, budgets,
                                 max_budget: int, pix_offset) -> RenderState:
    """wavefront_render_budget over one pixel slab: ``state``/``budgets``
    hold the slab's rows, pixel ids are slab-local, RNG/camera coordinates
    add ``pix_offset`` (cf. wavefront.wavefront_render_slab). Per-device
    body of parallel.sharding.make_wavefront_budget_sharded_step."""
    from tpurt.render import _check_camera_kind   # deferred: import cycle
    _check_camera_kind(cfg, camera)
    reject_camera_strata(cfg)
    Q = cfg.wf_pool
    budgets = jnp.clip(budgets.astype(jnp.int32), 0, max_budget)
    base_counts = state.n_samples.astype(jnp.int32)
    order, cum, total = _round_major_tables(budgets, max_budget)

    C = max(1, int(cfg.hero_wavelengths))
    if C > 1:
        from tpurt.ops.spectra import hero_emission_table_jnp
        hero_tabs = [hero_emission_table_jnp(
            scene.light_color[li], scene.light_intensity[li],
            scene.light_temp[li], C) for li in range(scene.num_lights)]
    else:
        hero_tabs = None

    pool = WavefrontPool(
        pix=jnp.zeros((Q,), jnp.int32),
        o=jnp.zeros((Q, 3)), d=jnp.zeros((Q, 3)),
        tp=jnp.zeros((Q, 3)), rad=jnp.zeros((Q, 3)),
        lam=jnp.zeros((Q,)), rng=jnp.zeros((Q,), jnp.uint32),
        bounce=jnp.zeros((Q,), jnp.int32),
        active=jnp.zeros((Q,), bool),
        coll=jnp.zeros((Q,), bool),
    )

    def cond(carry):
        pool, next_work, rgb, ns, rays, sweeps = carry
        return ((next_work < total) | jnp.any(pool.active)) \
            & (sweeps < cfg.wf_max_sweeps)

    def body(carry):
        pool, next_work, rgb, ns, rays, sweeps = carry
        pool, next_work = _regen_budget(
            cfg, camera, pool, next_work, base_seed, base_counts,
            order, cum, total, pix_offset)
        pool, terminated, nrays = _sweep(scene, cfg, pool, hero_tabs)
        t3 = terminated[:, None]
        prad = pool.rad
        if cfg.radiance_clamp > 0.0:
            prad = jnp.minimum(prad, jnp.float32(cfg.radiance_clamp))
        rgb = rgb.at[pool.pix].add(jnp.where(t3, prad, 0.0),
                                   mode="drop")
        ns = ns.at[pool.pix].add(jnp.where(terminated, 1.0, 0.0),
                                 mode="drop")
        return (pool, next_work, rgb, ns, rays + nrays, sweeps + 1)

    carry = (pool, jnp.int32(0), state.rgb_sum, state.n_samples,
             state.rays, jnp.int32(0))
    pool, next_work, rgb, ns, rays, sweeps = jax.lax.while_loop(
        cond, body, carry)

    return dataclasses.replace(
        state,
        rgb_sum=rgb,
        n_samples=ns,
        iteration=state.iteration + jnp.int32(max_budget),
        rays=rays,
    )


def _box3(img):
    """3x3 box filter with edge replication on an (H, W) map."""
    p = jnp.pad(img, 1, mode="edge")
    acc = jnp.zeros_like(img)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            acc = acc + p[dy:dy + img.shape[0], dx:dx + img.shape[1]]
    return acc / 9.0


@functools.partial(jax.jit, static_argnames=("cfg", "smooth"))
def variance_proxy(cfg: RenderConfig, sum_a, n_a, sum_b, n_b,
                   smooth: bool = True):
    """Per-pixel noise proxy from two independent half-estimates.

    The proxy is |luma(mean_a) - luma(mean_b)| — an unbiased-magnitude draw
    of the estimator's half-sample deviation — box-smoothed so single lucky
    pixels don't zero out their budget, plus a relative floor so every
    pixel keeps nonzero sampling probability (keeps the final image free of
    never-resampled outliers). Returns a (padded,) f32 map, pad rows 0."""
    luma = jnp.asarray(LUMA, jnp.float32)
    mean_a = sum_a / jnp.maximum(n_a, 1.0)[:, None]
    mean_b = sum_b / jnp.maximum(n_b, 1.0)[:, None]
    # HIGHEST: a float32 product must not run in TF32 on the GPU
    d = jnp.abs(jnp.matmul(mean_a - mean_b, luma,
                           precision=jax.lax.Precision.HIGHEST))
    n = cfg.n_pixels
    img = d[:n].reshape(cfg.height, cfg.width)
    if smooth:
        img = _box3(img)
    floor = 0.05 * jnp.mean(img) + 1e-12
    img = img + floor
    out = jnp.zeros((sum_a.shape[0],), jnp.float32)
    return out.at[:n].set(img.reshape(-1))


def allocate_budgets(proxy, total: int, max_budget: int,
                     power: float = 0.5):
    """Spend ``total`` samples across pixels proportionally to
    ``proxy ** power``.

    power=1 is the classical variance-proportional rule; the default 0.5
    dampens it against pilot-proxy noise, which measures strictly better
    or equal at equal rays (tools/quality.py --adaptive: cornell eff
    0.97 -> 1.04, config3 1.156 -> 1.150). Rounded to ints and clipped to
    [0, max_budget]; the realized sum may differ from ``total`` by
    rounding (the caller reads n_samples for the exact count). Pad rows
    (proxy == 0) get 0."""
    p = jnp.where(proxy > 0, proxy, 0.0) ** power
    p = p / jnp.maximum(jnp.sum(p), 1e-30)
    alloc = jnp.round(p * jnp.float32(total)).astype(jnp.int32)
    return jnp.clip(alloc, 0, max_budget)


def render_adaptive(scene: Scene, cfg: RenderConfig, camera: Camera,
                    base_seed=0, spp: int = 64, pilot_spp: int = 8,
                    budget_cap: int = 16, smooth: bool = True,
                    alloc_power: float = 0.5):
    """Adaptive render at a mean of ``spp`` samples/pixel.

    Phase 1: two uniform pilot passes of pilot_spp/2 each (the halves are
    consecutive windows of the progressive sequence, so they are
    independent). Phase 2: their disagreement sets a per-pixel variance
    proxy, and the remaining (spp - pilot_spp) * n_pixels samples are spent
    proportionally to proxy**alloc_power (per-pixel cap: budget_cap * the
    remaining mean). Returns (state, budgets). resolve_image handles the
    nonuniform counts (per-pixel alpha divide, blit.wgsl:38 semantics)."""
    if pilot_spp < 2 or pilot_spp % 2:
        raise ValueError("pilot_spp must be an even count >= 2")
    if spp < pilot_spp:
        raise ValueError("spp must be >= pilot_spp")
    h = pilot_spp // 2
    remaining = (spp - pilot_spp) * cfg.n_pixels
    max_budget = max(1, (spp - pilot_spp) * budget_cap)
    if cfg.n_pixels * max_budget >= 2**31:
        raise ValueError("summed budget bound overflows int32 — lower "
                         "budget_cap or split into multiple epochs")

    if cfg.backend == "pallas":
        # full-estimator adaptivity (photons included): per-lane budgets in
        # the regenerative megakernel (kernels.mega_regen); pilots through
        # the standard render() dispatch so they match the uniform path
        from tpurt.kernels.mega_regen import (render_budget_regen,
                                              render_regen)
        uniform_fn, budget_fn = render_regen, render_budget_regen
    else:
        uniform_fn, budget_fn = wavefront_render, wavefront_render_budget

    state = init_state(cfg)
    state = uniform_fn(scene, cfg, camera, state, base_seed, h)
    sum_a, n_a = state.rgb_sum, state.n_samples
    state = uniform_fn(scene, cfg, camera, state, base_seed, h)
    sum_b = state.rgb_sum - sum_a
    n_b = state.n_samples - n_a

    proxy = variance_proxy(cfg, sum_a, n_a, sum_b, n_b, smooth)
    budgets = allocate_budgets(proxy, remaining, max_budget, alloc_power)
    if remaining > 0:
        state = budget_fn(scene, cfg, camera, state, base_seed, budgets,
                          max_budget)
    return state, budgets
