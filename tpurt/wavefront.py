"""Wavefront path tracer: a fixed-capacity persistent ray pool with
compaction-by-regeneration.

The reference ships a *disabled, unfinished* wavefront tracer
(ref: src/wavefront.rs — commented out at lib.rs:24; src/kernels/
wavefront.wgsl — stages wf_generate/extend/shade/accumulate looped x30 per
pixel thread, per-ray state flags but NO compaction: its queue-length
atomics are declared and never used, wavefront.wgsl:28-31 /
wavefront.rs:134-138). BASELINE.json config 5 names the finished form:
"ray queues with compaction".

On a GPU, compaction means sorting the surviving rays to the front of a
queue so warps stay dense. With static shapes and no per-lane scatter in
the hot loop, the array equivalent is **regeneration**: a persistent
pool of Q ray slots that is ALWAYS dense. Each sweep:

  extend   intersect all Q slots with the scene (batched sweeps)
  shade    full material set: NEE + Oren-Nayar / dielectric GGX scatter
           (the reference's wavefront shade stage was Lambertian-only;
           ours matches the mega-kernel physics so mixed-material scenes
           render identically — wgsl's sky gradient on miss is preserved
           behind cfg.sky_gradient, default off to match the mega kernel's
           black sky, mega_kernel.wgsl:617-620)
  splat    terminated slots scatter-add their radiance into the image
           (one segment-sum per sweep — the array "queue drain")
  regen    dead slots immediately pull the next pending (pixel, sample)
           work item and become fresh camera rays — occupancy stays ~100%
           regardless of path-length divergence, which is exactly what GPU
           queue compaction buys, without sorting inside the loop.

Pool capacity Q is independent of the image size ("tiled so pixel count can
exceed on-chip memory", SURVEY.md §5): work items are enumerated as
pixel-major sample indices and handed to slots on demand.

The photon/SPPM pass is a per-pixel-owned second stage in the reference
mega kernel and has no wavefront counterpart there; wavefront rendering here
is camera-path + NEE only (enable_photons is ignored), like the reference's.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from tpurt.camera import Camera
from tpurt.config import RenderConfig
from tpurt.integrate import (
    _HIT,
    intersect_scene,
    light_emission_rgb,
    material_lookup,
    sample_direct_lighting,
    scatter_and_rr,
)
from tpurt.ops import rng as rngmod
from tpurt.ops.bsdf import normalize
from tpurt.ops.spectra import sample_wavelength
from tpurt.render import RenderState, _frame_seed


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class WavefrontPool:
    """The persistent ray pool (all arrays length Q = cfg.wf_pool)."""
    pix: jnp.ndarray        # (Q,)   i32 — owning pixel index
    o: jnp.ndarray          # (Q, 3) f32 — ray origin
    d: jnp.ndarray          # (Q, 3) f32 — ray direction
    tp: jnp.ndarray         # (Q, 3) f32 — path throughput
    rad: jnp.ndarray        # (Q, 3) f32 — accumulated radiance of this path
    lam: jnp.ndarray        # (Q,)   f32 — hero wavelength
    rng: jnp.ndarray        # (Q,)   u32 — PCG stream
    bounce: jnp.ndarray     # (Q,)   i32 — bounces taken so far
    active: jnp.ndarray     # (Q,)   bool
    coll: jnp.ndarray       # (Q,)   bool — hero-wavelength collapse (only
    #   meaningful when cfg.hero_wavelengths > 1 and dispersion is on)


def _regen(cfg: RenderConfig, camera: Camera, pool: WavefrontPool,
           next_sample, next_pix, spp, base_seed, it0, pix_offset, n_valid):
    """Refill dead slots with the next pending (pixel, sample) work items.

    The work queue is enumerated pixel-major as a (sample, pixel) pair of
    counters rather than one flat index — sample*n_pixels+pixel overflows
    int32 past ~1k spp at 1080p. Returns (pool, next_sample, next_pix).

    Pixel ids are local to the slab [pix_offset, pix_offset + n_valid)
    (pool.pix indexes the caller's state arrays); RNG streams and camera
    rays use the GLOBAL pixel coordinate, so a sharded slab draws exactly
    the single-chip samples. The whole-image case is pix_offset=0,
    n_valid=cfg.n_pixels.
    """
    n_pix = jnp.maximum(n_valid, 1)  # guard all-padding slabs (n_valid == 0)
    dead = ~pool.active
    # rank of each dead slot among dead slots -> its claimed work item
    rank = jnp.cumsum(dead.astype(jnp.int32)) - 1
    p = next_pix + rank           # < n_pix + Q: no overflow
    sample = next_sample + p // n_pix
    pix = (p % n_pix).astype(jnp.int32)
    have_work = dead & (sample < spp) & (n_valid > 0)
    gpix = pix_offset + pix       # global pixel id (< cfg.n_pixels)

    # per-(pixel, sample) stream: identical construction to the progressive
    # renderer (render.py), offset by the carried iteration so progressive
    # continuation draws NEW samples (cf. the fused kernel's it0_i + sample)
    new_pool = _issue(cfg, camera, pool, pix, gpix, it0 + sample,
                      have_work, base_seed)
    issued = jnp.sum(have_work.astype(jnp.int32))
    np2 = next_pix + issued
    return new_pool, next_sample + np2 // n_pix, np2 % n_pix


def _issue(cfg: RenderConfig, camera: Camera, pool: WavefrontPool,
           pix, gpix, seed_iter, have_work, base_seed) -> WavefrontPool:
    """Turn the claimed work items into fresh camera rays in the dead slots.

    `pix` is the state-row index the path will splat into, `gpix` the global
    pixel coordinate (they differ only under slab sharding), `seed_iter` the
    per-slot progressive sample index used for the RNG stream. Shared by the
    uniform enumeration (_regen) and the per-pixel-budget enumeration
    (adaptive._regen_budget) so both draw bit-identical streams."""
    px = gpix % cfg.width
    py = gpix // cfg.width
    seed = _frame_seed(base_seed, seed_iter)
    rng = rngmod.seed_pixels(seed, px, py)

    # cfg.qmc: spawn draws from the Owen-scrambled Sobol stream keyed on
    # the per-slot global sample index (same pairing as integrate.py)
    if cfg.qmc:
        from tpurt.ops import qmc as qmcmod
        src = qmcmod.spawn_stream(base_seed, seed_iter, px, py)
    else:
        src = rng
    u_jit, src = rngmod.rand_2f(src)
    u = (px.astype(jnp.float32) + u_jit[:, 0]) / jnp.float32(cfg.width)
    v = (py.astype(jnp.float32) + u_jit[:, 1]) / jnp.float32(cfg.height)
    from tpurt.camera import spawn_camera_rays
    ro, rd, src = spawn_camera_rays(cfg, camera, u, v, src)

    u_lam, src = rngmod.rand_1f(src)
    if not cfg.qmc:
        rng = src
    lam = sample_wavelength(u_lam)

    sel = have_work
    sel3 = sel[:, None]
    return WavefrontPool(
        pix=jnp.where(sel, pix, pool.pix),
        o=jnp.where(sel3, ro, pool.o),
        d=jnp.where(sel3, rd, pool.d),
        tp=jnp.where(sel3, 1.0, pool.tp),
        rad=jnp.where(sel3, 0.0, pool.rad),
        lam=jnp.where(sel, lam, pool.lam),
        rng=jnp.where(sel, rng, pool.rng),
        bounce=jnp.where(sel, 0, pool.bounce),
        active=pool.active | sel,
        coll=jnp.where(sel, False, pool.coll),
    )


def _sweep(scene, cfg: RenderConfig, pool: WavefrontPool,
           hero_tabs=None):
    """One extend+shade sweep over the whole pool (the reference's
    wf_extend + wf_shade stages, wavefront.wgsl:186-246, upgraded to the
    mega kernel's full material set).

    Returns (pool, terminated_mask, ray_count). Terminated slots keep their
    rad/pix so the caller can splat them before regeneration.
    """
    active = pool.active
    rng = pool.rng
    rays = jnp.sum(active.astype(jnp.float32)) if cfg.count_rays else jnp.float32(0.0)

    hit = intersect_scene(scene, cfg, pool.o, pool.d)
    found = hit["t"] < _HIT

    color, rough, ior, mtype = material_lookup(scene, hit["mat"])
    is_diffuse = mtype == 0
    wo = -pool.d
    n = hit["normal"]
    loc = hit["loc"]

    # miss: black sky like the mega kernel; the spectral environment
    # emitter (cfg.sky_intensity > 0 — see integrate.sky_emission_rgb) or
    # the legacy RGB gradient (ref: wavefront.wgsl:129-131) behind flags
    rad = pool.rad
    if float(cfg.sky_intensity) > 0.0:
        from tpurt.integrate import _sky_tint, sky_emission_rgb
        Cs = max(1, int(cfg.hero_wavelengths))
        if Cs > 1:
            from tpurt.ops.spectra import (hero_emission_lookup,
                                           hero_emission_table_jnp)
            em = hero_emission_lookup(
                hero_emission_table_jnp(jnp.ones((3,), jnp.float32),
                                        cfg.sky_intensity, cfg.sky_temp,
                                        Cs), Cs, pool.lam)
            if cfg.dispersion_in_camera_path:
                em = jnp.where(pool.coll[:, None],
                               sky_emission_rgb(cfg, pool.lam), em)
        else:
            em = sky_emission_rgb(cfg, pool.lam)
        rad = rad + jnp.where((active & ~found)[:, None],
                              pool.tp * em * _sky_tint(cfg, pool.d), 0.0)
    elif cfg.sky_gradient:
        t_sky = 0.5 * (normalize(pool.d, eps=1e-30)[:, 1] + 1.0)
        sky = (1.0 - t_sky)[:, None] * jnp.ones((1, 3)) \
            + t_sky[:, None] * jnp.asarray([[0.5, 0.7, 1.0]], jnp.float32)
        rad = rad + jnp.where((active & ~found)[:, None], pool.tp * sky, 0.0)

    # NEE (diffuse lanes consume it); hero-wavelength averaging per
    # RenderConfig.hero_wavelengths (see integrate.trace_camera_paths)
    C = max(1, int(cfg.hero_wavelengths))
    track_collapse = C > 1 and cfg.dispersion_in_camera_path
    if C > 1:
        from tpurt.ops.spectra import hero_emission_lookup
        # tables are scene constants, hoisted by the caller out of the
        # sweep while_loop (cf. integrate.trace_camera_paths)
        rgbs = [hero_emission_lookup(hero_tabs[li], C, pool.lam)
                for li in range(scene.num_lights)]
        if track_collapse:
            # full-weight hero after collapse (no 1/C; see integrate.py)
            hero = light_emission_rgb(scene, pool.lam)
            rgbs = [jnp.where(pool.coll[:, None], hero[li], rgbs[li])
                    for li in range(scene.num_lights)]
    else:
        rgbs = None
    direct, rng = sample_direct_lighting(scene, cfg, loc, n, pool.lam,
                                         rng, light_rgbs=rgbs)

    # type-3 emitter hit (see Material.emissive): add emission; the lane
    # terminates below. Masked math — no RNG draws, so exactness holds.
    is_em = mtype == 3
    from tpurt.ops.spectra import VISIBLE_RANGE
    from tpurt.integrate import cie_to_rgb
    emB_flat = cie_to_rgb(pool.lam) * jnp.float32(VISIBLE_RANGE)
    if C > 1:
        from tpurt.ops.spectra import (hero_emission_lookup,
                                       hero_emission_table_jnp)
        emB = hero_emission_lookup(
            hero_emission_table_jnp(jnp.ones((3,), jnp.float32), 1.0, 0.0,
                                    C), C, pool.lam)
        if track_collapse:
            emB = jnp.where(pool.coll[:, None], emB_flat, emB)
    else:
        emB = emB_flat
    rad = rad + jnp.where((active & found & is_em)[:, None],
                          pool.tp * color * emB, 0.0)

    lane_d = active & found & is_diffuse
    rad = rad + jnp.where(lane_d[:, None], pool.tp * color * direct, 0.0)
    if cfg.count_rays:
        rays = rays + jnp.sum(lane_d.astype(jnp.float32)) * (
            min(1, scene.num_lights) if cfg.light_sample != "all"
            else scene.num_lights)

    # scatter (same draw order as the mega integrator)
    wi, new_tp, new_o, scat_ok, rr_live, rng = scatter_and_rr(
        cfg, wo, n, loc, color, rough, ior, mtype, pool.lam, pool.tp, rng,
        camera_path=True)

    depth_ok = (pool.bounce + 1) < cfg.depth
    cont = active & found & scat_ok & rr_live & depth_ok & ~is_em
    terminated = active & ~cont

    new_pool = WavefrontPool(
        pix=pool.pix,
        o=jnp.where(cont[:, None], new_o, pool.o),
        d=jnp.where(cont[:, None], wi, pool.d),
        tp=jnp.where(cont[:, None], new_tp, pool.tp),
        rad=rad,
        lam=pool.lam,
        rng=rng,
        bounce=pool.bounce + 1,
        active=cont,
        coll=pool.coll | (active & found
                          & ~(is_diffuse | (mtype == 2) | is_em))
        if track_collapse else pool.coll,
    )
    return new_pool, terminated, rays


@functools.partial(jax.jit, static_argnames=("cfg",))
def wavefront_render(scene, cfg: RenderConfig, camera: Camera,
                     state: RenderState, base_seed, spp) -> RenderState:
    """Render `spp` samples/pixel through the persistent wavefront pool.

    Runs entirely under one jit: a while_loop of sweeps that exits when
    every work item has been issued and the pool has drained. Accumulates
    into the same RenderState as the progressive renderer (resolve_image /
    checkpointing work unchanged); vispoints/photon state are untouched.
    """
    return wavefront_render_slab(scene, cfg, camera, state, base_seed, spp,
                                 jnp.int32(0), jnp.int32(cfg.n_pixels))


def reject_camera_strata(cfg: RenderConfig) -> None:
    """The wavefront tracers draw the UNSTRATIFIED camera scatter sequence;
    silently accepting camera_strata_bounce would break same-seed parity
    with the other backends (render._wavefront_dispatch and the sharded
    builders all route through this check)."""
    if cfg.camera_strata_bounce:
        raise ValueError(
            "camera_strata_bounce is not implemented by the wavefront "
            "tracers — disable it for wavefront backends (photon strata "
            "flags are inert here: no photon pass)")


def wavefront_render_slab(scene, cfg: RenderConfig, camera: Camera,
                          state: RenderState, base_seed, spp,
                          pix_offset, n_valid) -> RenderState:
    """wavefront_render over one pixel slab: `state` holds the slab's rows,
    pixel ids are slab-local, RNG/camera coordinates are global (see _regen).
    This is the per-device body of parallel.sharding.make_wavefront_sharded
    _step; the public wavefront_render is the pix_offset=0 whole image."""
    from tpurt.render import _check_camera_kind   # deferred: render imports us
    _check_camera_kind(cfg, camera)
    reject_camera_strata(cfg)
    Q = cfg.wf_pool
    spp = jnp.asarray(spp, jnp.int32)
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
        pool, next_sample, next_pix, rgb, ns, rays, sweeps = carry
        more_work = (next_sample < spp) & (n_valid > 0)
        return (more_work | jnp.any(pool.active)) & (sweeps < cfg.wf_max_sweeps)

    def body(carry):
        pool, next_sample, next_pix, rgb, ns, rays, sweeps = carry
        pool, next_sample, next_pix = _regen(
            cfg, camera, pool, next_sample, next_pix, spp, base_seed,
            state.iteration, pix_offset, n_valid)
        pool, terminated, nrays = _sweep(scene, cfg, pool, hero_tabs)
        # splat: drain finished paths into the accumulation image
        t3 = terminated[:, None]
        prad = pool.rad
        if cfg.radiance_clamp > 0.0:
            prad = jnp.minimum(prad, jnp.float32(cfg.radiance_clamp))
        rgb = rgb.at[pool.pix].add(jnp.where(t3, prad, 0.0),
                                   mode="drop")
        ns = ns.at[pool.pix].add(jnp.where(terminated, 1.0, 0.0),
                                 mode="drop")
        return (pool, next_sample, next_pix, rgb, ns, rays + nrays, sweeps + 1)

    carry = (pool, jnp.int32(0), jnp.int32(0), state.rgb_sum,
             state.n_samples, state.rays, jnp.int32(0))
    pool, next_sample, next_pix, rgb, ns, rays, sweeps = jax.lax.while_loop(
        cond, body, carry)

    return dataclasses.replace(
        state,
        rgb_sum=rgb,
        n_samples=ns,
        iteration=state.iteration + spp,
        rays=rays,
    )
