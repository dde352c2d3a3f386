"""Regenerative megakernel: per-lane sample regeneration with the full
SPPM photon pass, compiled for the GPU through Pallas' Triton route.

A tile-synchronized kernel, running one progressive sample per call, makes
every lane wait for the tile's longest camera path and then for the
longest walk of each of the K photons. This kernel keeps each lane busy on
ITS OWN work instead: a per-lane state machine

    camera path  ->  photon walk k=0..K-1  ->  finalize  ->  next sample

where every transition spawns at the START of an iteration (finalize ->
camera spawn -> photon spawn -> bounce), so a lane that dies in iteration i
is already tracing its next task in iteration i+1 — no idle bubbles, ~100%
occupancy for the whole spp batch, and zero host round-trips between
samples.

Every draw position is a pure function of (pixel, sample, phase, k) thanks
to the per-photon streams (rng.photon_stream), the radius schedule is
applied per-lane at sample transitions with the same float sequence, and
vispoints live in the lane's own output channels (no cross-lane reads), so
results match the XLA integrator: tests assert exact ray-count equality.

One program is one tile of `cfg.pallas_lanes` pixels, (R, 128) planes with
R = lanes / 128, run by lanes / 16 warps (two threads per lane). Whole-tile
votes (the spawn conds, the loop exit) are max-reductions over the tile.
The camera and the scalars live in small device arrays read by scalar
loads; the primitive tables stay in device memory (L2-resident at these
sizes).

Physics, scene freezing, and primitive modes are shared with
tpurt.kernels.mega_pallas (same reference citations apply).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from tpurt.config import RenderConfig
from tpurt.kernels.mega_pallas import (
    EPS,
    _HIT,
    N_CHANNELS,
    _VMAT,
    _VNORM,
    _VPOS,
    _VTP,
    _VWO,
    FrozenScene,
    _any,
    _mask_f32,
    _mask_i32,
    _material_lookup_static,
    _make_scene_fns,
    _single_lambda_em_c,
    _sky_em_c,
    _sky_tint_c,
    _flat_em_c,
    _is_emissive_static,
    _prim_tables,
    PHOTON_CONE_COS,
    check_scene,
    freeze_scene,
    nee_direct_c,
    scatter_rr_c,
    planes_pixel_order,
    pixels_to_planes_order,
    state_to_planes,
)
from tpurt.ops import rng as rngmod
from tpurt.ops import soa as s
from tpurt.ops.scatter_c import evaluate_bsdf_c
from tpurt.ops.spectra import (DISPERSION_B, VISIBLE_MIN, VISIBLE_RANGE,
                               hero_emission_table)
from tpurt.render import _frame_seed, sppm_radius_step
from tpurt.runtime import pallas_interpret

# Scalar arguments are small device arrays read by scalar loads, every
# length a power of two (the Triton lowering requires it): the camera rows
# (4, or 8 with motion blur) x 3 padded to _CAM_LEN f32; i32 [spp, starting
# iteration, depth bound, first tile]; u32 [seed]; f32 [starting SPPM
# radius, starting iteration].
_CAM_LEN = 32


def _make_regen_kernel(fscene: FrozenScene, cfg: RenderConfig, lanes: int,
                       budget_mode: bool = False):
    """budget_mode (adaptive sampling, tpurt/adaptive.py) adds one f32
    (3, R, 128) aux plane input — per-lane sample budgets, progressive base
    counts, and starting SPPM radii — and bounds each lane's sample loop by
    its own budget instead of the scalar spp. Per-lane radii continue each
    PIXEL's own schedule (base count = the pixel's accumulated n_samples),
    which is the correct SPPM behavior under non-uniform sample counts.
    With budget_mode=False the emitted kernel is UNCHANGED."""
    R = lanes // 128
    W, H = cfg.width, cfg.height
    MATS = fscene.materials
    LIGHTS = fscene.lights
    L = len(LIGHTS)
    K = cfg.k_photons if (cfg.enable_photons and L > 0) else 0
    any_dielectric = any(m.mtype == 1 for m in MATS)
    any_metal = any(m.mtype == 2 for m in MATS)
    # hero-wavelength sampling (see RenderConfig.hero_wavelengths / the XLA
    # integrator, integrate.trace_camera_paths): NEE emission averages C
    # rotated wavelengths; a collapse bit is only needed when a dispersive
    # camera interaction can make the path hero-specific
    C_HERO = max(1, int(cfg.hero_wavelengths))
    track_collapse = (C_HERO > 1 and cfg.dispersion_in_camera_path
                      and any_dielectric)
    if C_HERO > 1:
        HERO_TABS = [hero_emission_table(lt.color, lt.intensity, lt.temp,
                                         C_HERO) for lt in LIGHTS]
        HERO_DELTA = VISIBLE_RANGE / C_HERO
    # Environment emission (cfg.sky_intensity > 0, EXTENSION): computed at
    # miss time from the lane's lambda plane — the lane state stays
    # unchanged (unlike the light emissions, which NEE needs every bounce,
    # the sky is read once per path at most).
    SKY_ON = float(cfg.sky_intensity) > 0.0
    if SKY_ON and C_HERO > 1:
        SKY_TAB = hero_emission_table((1.0, 1.0, 1.0), cfg.sky_intensity,
                                      cfg.sky_temp, C_HERO)
    # type-3 emissive materials (see Material.emissive): lambda-only flat
    # emission base, evaluated at hit time from the lane's lambda plane
    ANY_EM = any(m.mtype == 3 for m in MATS)
    if ANY_EM and C_HERO > 1:
        EMB_TAB = hero_emission_table((1.0, 1.0, 1.0), 1.0, 0.0, C_HERO)

    def kernel(planes_ref, cam_ref, ip_ref, seed_ref, fp_ref, sph_ref,
               tri_ref, *rest):
        if budget_mode:
            aux_ref, out_ref, rays_ref = rest
        else:
            out_ref, rays_ref = rest
        tile = pl.program_id(0)
        gtile = ip_ref[3] + tile
        row = jax.lax.broadcasted_iota(jnp.int32, (R, 128), 0)
        col = jax.lax.broadcasted_iota(jnp.int32, (R, 128), 1)
        if cfg.pallas_block_tiles:
            NBX = -(-W // 128)  # tile = (R x 128) image block (see config)
            px = (gtile % NBX) * 128 + col
            py = (gtile // NBX) * R + row
            valid_px = (px < W) & (py < H)
            px = jnp.minimum(px, W - 1)
            py = jnp.minimum(py, H - 1)
        else:
            idx = gtile * lanes + row * 128 + col
            px = jnp.remainder(idx, W)
            py = jnp.minimum(idx // W, H - 1)
            valid_px = idx < W * H
        base_seed = seed_ref[0]
        spp = ip_ref[0]
        it0_i = ip_ref[1]   # starting iteration (progressive continuation)
        # camera depth bound as a RUNTIME scalar: a depth-1 preview frame
        # shares the full kernel's compile (the bound only feeds a
        # jnp.where, never the loop structure)
        depth_i = ip_ref[2]
        r0 = fp_ref[0]

        def cam_row(r):
            return tuple(cam_ref[3 * r + c] for c in range(3))

        cam_o, cam_h, cam_v, cam_ll = (cam_row(r) for r in range(4))
        if cfg.motion_blur:
            cam_do, cam_dh, cam_dv, cam_dll = (cam_row(r)
                                               for r in range(4, 8))

        intersect, shadow = _make_scene_fns(fscene, cfg, sph_ref, tri_ref)

        # persistent planes: accumulation + vispoints live in out_ref
        for ch in range(N_CHANNELS):
            out_ref[ch] = planes_ref[ch]

        it0 = fp_ref[1]          # starting iteration (f32)
        if budget_mode:
            # per-lane planes supersede the scalars (budget counts are
            # small non-negative ints, exact in f32: truncation is exact)
            spp = aux_ref[0].astype(jnp.int32)      # budget
            it0_i = aux_ref[1].astype(jnp.int32)    # base count
            it0 = aux_ref[1]
            r0 = aux_ref[2]                         # SPPM radius
        izero = jnp.zeros((R, 128), jnp.int32)
        zero = jnp.zeros((R, 128), jnp.float32)
        z3 = (zero, zero, zero)
        st = {
            "anywork": jnp.int32(1),
            "phase": izero,              # 0 camera, 1 photon
            "sample": izero,
            "k": izero,
            "bounce": izero,
            "active": izero,
            "vp_stored": izero,
            "o": z3, "d": z3, "tp": z3, "rad": z3,
            "lam": zero,
            "em": tuple(zero for _ in range(3 * L)),
            "rng": izero.astype(jnp.uint32),
            "radius": zero + r0,
            "rays": jnp.float32(0.0),
        }
        if track_collapse:
            st["emh"] = tuple(zero for _ in range(3 * L))
            st["coll"] = izero

        def cond(st):
            return st["anywork"] > 0

        def body(st):
            phase, sample, k = st["phase"], st["sample"], st["k"]
            active = st["active"] > 0
            rad = st["rad"]
            radius = st["radius"]
            vp_stored = st["vp_stored"]

            # ---- finalize: all K photons done -> accumulate, next sample
            fin = ~active & (phase == 1) & (k >= K)
            # clamp only the SPLATTED value — the carried rad keeps growing
            # for unfinished lanes (one final clamp per sample, not per
            # iteration; see RenderConfig.radiance_clamp)
            if cfg.radiance_clamp > 0.0:
                cl = jnp.float32(cfg.radiance_clamp)
                rad_s = tuple(jnp.minimum(r, cl) for r in rad)
            else:
                rad_s = rad
            for c in range(3):
                out_ref[c] = out_ref[c] + jnp.where(fin, rad_s[c],
                                                    jnp.float32(0.0))
            sample = jnp.where(fin, sample + 1, sample)
            # SPPM radius schedule, per lane (same float sequence as the
            # host loop: it_new = it0 + sample, ref mega_kernel.rs:196-198)
            it_new = it0 + sample.astype(jnp.float32)
            factor = sppm_radius_step(cfg, it_new, jnp.float32(1.0))
            # multiply-form (see the accumulate above for why not select-form)
            radius = radius * jnp.where(fin, factor, jnp.float32(1.0))
            phase = jnp.where(fin, 0, phase)
            rad = s.vwhere(fin, z3, rad)

            # ---- camera spawn (lax.cond: most iterations have no spawning
            # lane, skipping the ~650-op CIE select chain entirely)
            spawn_c = ~active & (phase == 0) & (sample < spp) & valid_px
            # camera drift bound: pallas_regen_drift_cam (0 = the tight
            # bound) lets camera spawns run ahead of the photon gate —
            # see config.py; photon-phase entry is gated separately below
            drift_cam = (cfg.pallas_regen_drift_cam
                         or cfg.pallas_regen_drift)
            if cfg.pallas_regen_drift > 0:
                # bounded drift (cfg.pallas_regen_drift): hold a lane's
                # next-sample spawn while it is >= W samples ahead of the
                # tile's slowest unfinished lane. The min lane always
                # passes (sample == min_s < min_s + W), so the tile can
                # never deadlock; blocked lanes stay pending and re-test
                # next trip.
                live = (sample < spp) & valid_px
                # dead-lane fill: scalar spp is >= any live sample; in
                # budget mode a finished lane's own (small) budget would
                # drag the min down and stall the drift gate — use +inf
                min_s = jnp.min(jnp.where(
                    live, sample,
                    jnp.int32(2 ** 30) if budget_mode else spp))
                spawn_c &= sample < min_s + np.int32(drift_cam)
            # global sample index = iteration at call start + local sample:
            # progressive continuation draws NEW samples, never repeats
            samp_seed = _frame_seed(base_seed, it0_i + sample)
            # stratum seed: windowed global sample (photon_strata_window
            # re-aligns desynchronized lanes onto one cell epoch)
            strat_seed = samp_seed
            if cfg.photon_strata and cfg.photon_strata_window > 1:
                strat_seed = _frame_seed(
                    base_seed, rngmod.strata_epoch(cfg, it0_i + sample))

            def _cam_spawn_vals(_):
                rng_c = rngmod.seed_pixels(samp_seed, px, py)
                # cfg.qmc: spawn draws from the Owen-scrambled Sobol
                # stream, indexed by the per-lane GLOBAL sample — the
                # regenerative schedule interleaves samples across lanes,
                # and a pure function of (base_seed, pixel, sample, dim)
                # is invariant to that (same pairing as integrate/XLA)
                if cfg.qmc:
                    from tpurt.ops import qmc as qmcmod
                    src = qmcmod.spawn_stream(base_seed, it0_i + sample,
                                              px, py)
                else:
                    src = rng_c
                uj1, src = rngmod.rand_1f(src)
                uj2, src = rngmod.rand_1f(src)
                u = (px.astype(jnp.float32) + uj1) / jnp.float32(W)
                v = (py.astype(jnp.float32) + uj2) / jnp.float32(H)
                if cfg.motion_blur:
                    ut, src = rngmod.rand_1f(src)
                    ch = tuple(cam_h[c] + ut * cam_dh[c] for c in range(3))
                    cv = tuple(cam_v[c] + ut * cam_dv[c] for c in range(3))
                    co = tuple(cam_o[c] + ut * cam_do[c] for c in range(3))
                    d0 = tuple(cam_ll[c] + ut * cam_dll[c]
                               + u * ch[c] + v * cv[c] - co[c]
                               for c in range(3))
                    o0 = co
                else:
                    ch, cv = cam_h, cam_v
                    d0 = tuple(cam_ll[c] + u * cam_h[c] + v * cam_v[c] - cam_o[c]
                               for c in range(3))
                    o0 = s.vbroadcast(cam_o, u)
                if cfg.aperture > 0.0:
                    from tpurt.camera import lens_perturb_c
                    o0, d0, src = lens_perturb_c(
                        cfg.aperture, cfg.focus_dist, src, o0, d0,
                        ch, cv,
                        rngmod.rand_1f)
                ulam, src = rngmod.rand_1f(src)
                if not cfg.qmc:
                    rng_c = src
                lam_new = (jnp.float32(VISIBLE_MIN)
                           + ulam * jnp.float32(VISIBLE_RANGE))
                # hero-wavelength emission: C stratified lambdas share
                # this path; em = their averaged CIE-weighted emission via
                # the folded periodic table (one small lerp chain instead
                # of C full CIE chains), em_h = the hero's single-lambda
                # emission at full weight (used after a dispersive collapse)
                if C_HERO > 1:
                    em_new = []
                    for tab in HERO_TABS:
                        em_new.extend(s.hero_em_lookup_c(tab, HERO_DELTA,
                                                         lam_new))
                else:
                    em_new = _single_lambda_em_c(LIGHTS, lam_new)
                # post-collapse hero emission at FULL weight (the
                # dispersive dirac continuation is hero-only; no 1/C —
                # cf. pbrt-v4 TerminateSecondary)
                em_h = (_single_lambda_em_c(LIGHTS, lam_new)
                        if track_collapse else [])
                return (*o0, *d0, lam_new, rng_c, *em_new, *em_h)

            def _cam_spawn_skip(_):
                # `zero` is anchored to the z_ref load -> concrete layout
                n_em = 3 * L * (2 if track_collapse else 1)
                return (zero,) * 7 + (izero.astype(jnp.uint32),) \
                    + (zero,) * n_em

            vals = jax.lax.cond(_any(spawn_c), _cam_spawn_vals,
                                _cam_spawn_skip, 0)
            o0 = vals[0:3]
            d0 = vals[3:6]
            lam_new = vals[6]
            rng_c = vals[7]
            em_new = vals[8:8 + 3 * L]

            o = s.vwhere(spawn_c, o0, st["o"])
            d = s.vwhere(spawn_c, d0, st["d"])
            tp = s.vwhere(spawn_c, (zero + 1.0,) * 3, st["tp"])
            lam = jnp.where(spawn_c, lam_new, st["lam"])
            em = tuple(jnp.where(spawn_c, em_new[i], st["em"][i])
                       for i in range(3 * L))
            if track_collapse:
                emh_new = vals[8 + 3 * L: 8 + 6 * L]
                emh = tuple(jnp.where(spawn_c, emh_new[i], st["emh"][i])
                            for i in range(3 * L))
                coll = jnp.where(spawn_c, 0, st["coll"])
            rng = jnp.where(spawn_c, rng_c, st["rng"])
            bounce = jnp.where(spawn_c, 0, st["bounce"])
            vp_stored = jnp.where(spawn_c, 0, vp_stored)
            active = active | spawn_c

            # ---- photon spawn (k < K; per-photon stream; dynamic light),
            # also lax.cond-gated: photon emission construction only runs
            # on iterations where some lane transitions
            if K > 0:
                spawn_p = ~active & (phase == 1) & (k < K)
                if (cfg.pallas_regen_drift > 0
                        and drift_cam > cfg.pallas_regen_drift):
                    # photon-phase entry keeps the TIGHT bound: a lane
                    # whose camera pass ran ahead holds at k==0 until the
                    # tile minimum catches up (photons are the
                    # epoch-coherence-critical phase; k>0 continues
                    # freely — same sample, same epoch)
                    spawn_p &= (k > 0) | (
                        sample < min_s
                        + np.int32(cfg.pallas_regen_drift))

                def _ph_spawn_vals(_):
                    # ONE vectorized construction with the lane's own k as
                    # an i32 plane (photon_stream/emission_strata take
                    # dynamic k) instead of K unrolled constructions +
                    # selects — bit-identical streams, ~1/K the spawn
                    # cost, and this block runs nearly every iteration
                    # once lanes desynchronize. Only the LIGHT choice
                    # stays a (short, static) loop: k % L selects among L
                    # lights, and light constants are baked per light.
                    rkk = rngmod.photon_stream(samp_seed, px, py, k)
                    uc, rkk = rngmod.rand_1f(rkk)
                    up1, rkk = rngmod.rand_1f(rkk)
                    _u, rkk = rngmod.rand_1f(rkk)  # parity: drawn, unused
                    ue1, rkk = rngmod.rand_1f(rkk)
                    ue2, rkk = rngmod.rand_1f(rkk)
                    uh1, rkk = rngmod.rand_1f(rkk)
                    uh2, rkk = rngmod.rand_1f(rkk)
                    if cfg.photon_aim > 0.0:
                        # EXTENSION cfg.photon_aim: 3 extra draws AFTER
                        # the reference layout (same order as the XLA
                        # integrator's trace_photons)
                        uch, rkk = rngmod.rand_1f(rkk)
                        ua1, rkk = rngmod.rand_1f(rkk)
                        ua2, rkk = rngmod.rand_1f(rkk)
                    rng_pk = rkk
                    if cfg.photon_strata:
                        # tile-coherent emission cell per (sample, k)
                        uc, up1, ue1, ue2, uh1, uh2 = \
                            rngmod.apply_emission_strata(
                                strat_seed, rngmod.strata_k(cfg, k),
                                *rngmod.strata_counts(cfg),
                                uc, up1, ue1, ue2, uh1, uh2)
                    if cfg.photon_aim > 0.0:
                        # aim at the lane's own vispoint — the PERSISTENT
                        # one (stale vispoints stay valid aim/density
                        # targets, wgsl :1004's length test), same gate as
                        # the XLA path's vp_ok
                        vp_c = (out_ref[_VPOS], out_ref[_VPOS + 1],
                                out_ref[_VPOS + 2])
                        vp_ok = jnp.sqrt(s.vdot(vp_c, vp_c)) > 0.001
                        q_lane = jnp.where(vp_ok,
                                           np.float32(cfg.photon_aim),
                                           np.float32(0.0))
                        aim_choose = uch < q_lane
                    ph_o, ph_d, ph_tp = z3, z3, z3
                    for li in range(L):
                        sel = (k % L == li) if L > 1 else spawn_p
                        lt = LIGHTS[li]
                        if lt.ltype == 0:
                            ct = 1.0 - uc * np.float32(1.0 - PHOTON_CONE_COS)
                            stn = jnp.sqrt(jnp.maximum(0.0, 1.0 - ct * ct))
                            phi = jnp.float32(s.TWO_PI) * up1
                            cphi, sphi = jnp.cos(phi), jnp.sin(phi)
                            kd = tuple(
                                stn * cphi * np.float32(lt.cone_t[c])
                                + stn * sphi * np.float32(lt.cone_b[c])
                                + ct * np.float32(lt.cone_axis[c])
                                for c in range(3))
                            ko = s.vbroadcast(lt.pos, uc)
                            cf = (1.0 - PHOTON_CONE_COS) * 0.5
                            kt = s.vbroadcast(tuple(
                                lt.color[c] * lt.intensity / cfg.k_photons * cf
                                for c in range(3)), uc)
                        else:
                            su = (ue1 - 0.5) * np.float32(2.0 * lt.hw)
                            sv = (ue2 - 0.5) * np.float32(2.0 * lt.hw)
                            ko = tuple(
                                np.float32(lt.pos[c] + lt.normal[c] * EPS)
                                + su * np.float32(lt.tangent[c])
                                + sv * np.float32(lt.bitangent[c])
                                for c in range(3))
                            theta = jnp.float32(s.TWO_PI) * uh1
                            r_ = jnp.sqrt(uh2)
                            x_ = r_ * jnp.cos(theta)
                            y_ = r_ * jnp.sin(theta)
                            z_ = jnp.sqrt(jnp.maximum(0.0, 1.0 - r_ * r_))
                            kd = tuple(
                                x_ * np.float32(lt.tangent[c])
                                + y_ * np.float32(lt.bitangent[c])
                                + z_ * np.float32(lt.normal[c])
                                for c in range(3))
                            kt = s.vbroadcast(tuple(
                                lt.color[c] * lt.intensity / cfg.k_photons
                                for c in range(3)), uc)
                            if cfg.photon_aim > 0.0:
                                # cfg.photon_aim (area lights only): aimed
                                # cone with the defensive-mixture weight —
                                # same helper + op order as the XLA path
                                ad, ax, cos_a = s.aimed_cone_c(
                                    ko, vp_c, radius,
                                    np.float32(cfg.photon_aim_widen),
                                    ua1, ua2)
                                kd = s.vwhere(aim_choose, ad, kd)
                                ln = tuple(np.float32(lt.normal[c])
                                           for c in range(3))
                                wv = s.aim_mixture_weight_c(
                                    kd, ln, ax, cos_a, q_lane)
                                kt = s.vscale(kt, wv)
                        if L > 1:
                            ph_o = s.vwhere(sel, ko, ph_o)
                            ph_d = s.vwhere(sel, kd, ph_d)
                            ph_tp = s.vwhere(sel, kt, ph_tp)
                        else:
                            ph_o, ph_d, ph_tp = ko, kd, kt
                    return (*ph_o, *ph_d, *ph_tp, rng_pk)

                def _ph_spawn_skip(_):
                    return (zero,) * 9 + (izero.astype(jnp.uint32),)

                pvals = jax.lax.cond(_any(spawn_p), _ph_spawn_vals,
                                     _ph_spawn_skip, 0)
                ph_o = pvals[0:3]
                ph_d = pvals[3:6]
                ph_tp = pvals[6:9]
                rng_pk = pvals[9]

                o = s.vwhere(spawn_p, ph_o, o)
                d = s.vwhere(spawn_p, ph_d, d)
                tp = s.vwhere(spawn_p, ph_tp, tp)
                rng = jnp.where(spawn_p, rng_pk, rng)
                bounce = jnp.where(spawn_p, 0, bounce)
                active = active | spawn_p

            rays = st["rays"]
            if cfg.count_rays:
                rays = rays + jnp.sum(_mask_f32(active))

            is_cam = phase == 0
            is_ph = phase == 1

            # ---- shared bounce: intersect + material
            if cfg.pallas_phase_split_votes and K > 0:
                # two phase-split culling votes: each phase prunes like a
                # pure tile instead of dragging the other phase's rays
                # into every leaf vote. Bit-identical per-lane results (a
                # leaf a phase's vote skips is one no lane of that phase
                # could be improved by); see config.py.
                t_c, loc_c, n_c, mat_c = intersect(o, d, active & is_cam)
                t_p, loc_p, n_p, mat_p = intersect(o, d, active & is_ph)
                t = jnp.where(is_cam, t_c, t_p)
                loc = s.vwhere(is_cam, loc_c, loc_p)
                n = s.vwhere(is_cam, n_c, n_p)
                mat = jnp.where(is_cam, mat_c, mat_p)
            else:
                t, loc, n, mat = intersect(o, d, active)
            found = t < _HIT

            # environment emission on CAMERA miss (photon lanes just die;
            # an environment emits, it does not receive)
            if SKY_ON:
                em_s = (s.hero_em_lookup_c(SKY_TAB, HERO_DELTA, lam)
                        if C_HERO > 1 else _sky_em_c(cfg, lam))
                if track_collapse:
                    em_s = s.vwhere(coll > 0, _sky_em_c(cfg, lam), em_s)
                tint = _sky_tint_c(cfg, d)
                miss = active & is_cam & ~found
                rad = tuple(jnp.where(miss,
                                      rad[c] + tp[c] * em_s[c] * tint[c],
                                      rad[c]) for c in range(3))

            color, rough, ior, is_diffuse, is_metal = \
                _material_lookup_static(MATS, mat)
            wo = s.vneg(d)
            lam_um = lam * jnp.float32(1e-3)
            cauchy_add = jnp.float32(DISPERSION_B) / (lam_um * lam_um)

            # type-3 emitter hit: CAMERA lanes add emission (and terminate
            # below, as do photon lanes — emitters absorb photons)
            if ANY_EM:
                is_em = _is_emissive_static(MATS, mat)
                emb = (s.hero_em_lookup_c(EMB_TAB, HERO_DELTA, lam)
                       if C_HERO > 1 else _flat_em_c(lam))
                if track_collapse:
                    emb = s.vwhere(coll > 0, _flat_em_c(lam), emb)
                hit_em = active & is_cam & found & is_em
                rad = tuple(jnp.where(hit_em,
                                      rad[c] + tp[c] * color[c] * emb[c],
                                      rad[c]) for c in range(3))

            # ---- camera-only: vispoint store + NEE
            store = active & is_cam & found & is_diffuse & ~(vp_stored > 0)
            for kb, val in ((_VPOS, loc), (_VNORM, n), (_VWO, wo), (_VTP, tp)):
                for c in range(3):
                    out_ref[kb + c] = jnp.where(store, val[c],
                                                out_ref[kb + c])
            out_ref[_VMAT] = jnp.where(store, mat.astype(jnp.float32),
                                       out_ref[_VMAT])
            vp_stored = jnp.maximum(vp_stored, _mask_i32(store))

            # NEE consumes 2L draws on the CAMERA stream only (the photon
            # walk draws exactly 4 per bounce in the reference/megakernel);
            # photon lanes get their rng restored after this block.
            rng_pre_nee = rng
            if track_collapse:
                def emv_fn(li):
                    # post-collapse lanes transport only the hero's share
                    return tuple(jnp.where(coll > 0, emh[3 * li + c],
                                           em[3 * li + c]) for c in range(3))
            else:
                def emv_fn(li):
                    return (em[3 * li], em[3 * li + 1], em[3 * li + 2])
            direct, rng = nee_direct_c(
                LIGHTS, loc, n, lam, rng, shadow,
                lambda: active & is_cam & found & is_diffuse, emv_fn, z3,
                mode=cfg.light_sample)

            rng = jnp.where(is_cam, rng, rng_pre_nee)

            lane_d = active & is_cam & found & is_diffuse
            nee = s.vmul(s.vmul(tp, color), direct)
            rad = tuple(jnp.where(lane_d, rad[c] + nee[c], rad[c])
                        for c in range(3))
            if cfg.count_rays:
                rays = rays + jnp.sum(_mask_f32(lane_d)) * (
                    min(1, L) if cfg.light_sample != "all" else L)

            # ---- photon-only: density estimation at own vispoint
            if K > 0:
                vpos = (out_ref[_VPOS], out_ref[_VPOS + 1], out_ref[_VPOS + 2])
                vnorm = (out_ref[_VNORM], out_ref[_VNORM + 1],
                         out_ref[_VNORM + 2])
                vwo = (out_ref[_VWO], out_ref[_VWO + 1], out_ref[_VWO + 2])
                vtp = (out_ref[_VTP], out_ref[_VTP + 1], out_ref[_VTP + 2])
                vmat = out_ref[_VMAT].astype(jnp.int32)
                v_color, v_rough, v_ior, v_isdiff, v_ismetal = \
                    _material_lookup_static(MATS, vmat)
                dvec = s.vsub(loc, vpos)
                dist = jnp.sqrt(jnp.maximum(s.vdot(dvec, dvec), 0.0))
                near = dist < radius
                f = evaluate_bsdf_c(vwo, s.vneg(d), vnorm, v_color, v_rough,
                                     v_ior + cauchy_add, v_isdiff, v_ismetal)
                inv_pi_r2 = 1.0 / jnp.maximum(
                    jnp.float32(np.pi) * radius * radius, 1e-10)
                kern = (1.0 - dist / radius) * inv_pi_r2
                dens = s.vscale(s.vmul(s.vmul(vtp, f), tp), kern)
                hit_ph = active & is_ph & found & near
                rad = tuple(jnp.where(hit_ph, rad[c] + dens[c], rad[c])
                            for c in range(3))

            # ---- shared scatter (pdf mode + dispersion + RR per phase):
            # the regen kernel interleaves camera and photon lanes, so the
            # per-site knobs of scatter_rr_c are per-lane PLANES here
            if cfg.photon_strata and (cfg.photon_strata_bounce
                                      or cfg.camera_strata_bounce):
                def strata_fn(u2a, u2b, u_choice):
                    if cfg.photon_strata_bounce:
                        # tile-shared (sample, k, bounce) cell — PHOTON
                        # lanes only; k/bounce/strat_seed are planes here
                        sa, sb, sc = rngmod.apply_bounce_strata(
                            strat_seed, rngmod.strata_k(cfg, k), bounce,
                            rngmod.strata_counts(cfg)[1], u2a, u2b, u_choice)
                        u2a = jnp.where(is_ph, sa, u2a)
                        u2b = jnp.where(is_ph, sb, u2b)
                        u_choice = jnp.where(is_ph, sc, u_choice)
                    if cfg.camera_strata_bounce:
                        # camera analogue: (sample, bounce), disjoint key
                        ca, cb, cc = rngmod.apply_bounce_strata(
                            strat_seed, rngmod.CAMERA_STRATA_K, bounce,
                            rngmod.strata_counts(cfg)[1], u2a, u2b, u_choice)
                        u2a = jnp.where(is_cam, ca, u2a)
                        u2b = jnp.where(is_cam, cb, u2b)
                        u_choice = jnp.where(is_cam, cc, u_choice)
                    return u2a, u2b, u_choice
            else:
                strata_fn = None

            def eta_fn():
                if cfg.dispersion_in_camera_path:
                    eta_cam = ior + cauchy_add
                else:
                    eta_cam = ior  # reference quirk (wgsl :915)
                return jnp.where(is_cam, eta_cam, ior + cauchy_add)

            if track_collapse:
                def post_diel(is_diel):
                    # eta(lambda) steered this lane: only the hero
                    # transports onward (the NEE above used the
                    # pre-collapse selection)
                    return jnp.maximum(coll, _mask_i32(
                        active & is_cam & found & is_diel))
            else:
                post_diel = None

            wi, new_tp, new_o, scat_ok, rr_live, rng, coll_new = \
                scatter_rr_c(
                    cfg, wo, n, loc, color, rough, is_diffuse, is_metal,
                    tp, rng, any_dielectric=any_dielectric,
                    any_metal=any_metal, eta_fn=eta_fn,
                    # camera lanes use the VNDF pdf, photon lanes the
                    # Lambda+1 approximation — ONE shared scatter pass
                    camera_pdf=is_cam,
                    rr_thresh_fn=lambda: jnp.where(
                        is_cam, np.float32(cfg.rr_threshold),
                        np.float32(cfg.photon_rr_threshold)),
                    strata_fn=strata_fn, post_dielectric=post_diel,
                    # photon lanes only; camera lanes keep reference RR
                    rr_scale_fn=None if cfg.photon_rr_scale == 1.0
                    else (lambda: jnp.where(
                        is_cam, np.float32(1.0),
                        np.float32(cfg.photon_rr_scale))))
            if track_collapse and any_dielectric:
                coll = coll_new

            max_b = jnp.where(is_cam, depth_i, np.int32(cfg.max_photon_bounces))
            depth_ok = (bounce + 1) < max_b
            cont = active & found & scat_ok & rr_live & depth_ok
            if ANY_EM:
                cont = cont & ~is_em  # camera terminates, photons absorb

            # ---- deaths
            died = active & ~cont
            cam_died = died & is_cam
            ph_died = died & is_ph
            if K > 0:
                vpos0 = (out_ref[_VPOS], out_ref[_VPOS + 1],
                         out_ref[_VPOS + 2])
                vp_ok = (jnp.sqrt(s.vdot(vpos0, vpos0)) > 0.001) & valid_px
                phase = jnp.where(cam_died, 1, phase)
                k = jnp.where(cam_died, jnp.where(vp_ok, 0, K), k)
                k = jnp.where(ph_died, k + 1, k)
            else:
                # no photons: camera death goes straight to finalize
                phase = jnp.where(cam_died, 1, phase)
                k = jnp.where(cam_died, K, k)

            cont_i = _mask_i32(cont)
            pending = ((sample < spp) & valid_px) | (cont_i > 0) \
                | ((phase == 1) & ~active)
            # note: a lane at (phase 1, k>=K, inactive) still needs one
            # finalize pass; `pending` covers it via the phase-1 term until
            # sample passes spp... after the last sample finalizes, phase
            # returns to 0 and sample == spp, so pending goes false.
            anywork = jnp.max(_mask_i32(pending))

            out = {
                "anywork": anywork,
                "phase": phase, "sample": sample, "k": k,
                "bounce": bounce + 1,
                "active": cont_i, "vp_stored": vp_stored,
                "o": s.vwhere(cont, new_o, o),
                "d": s.vwhere(cont, wi, d),
                "tp": s.vwhere(cont, new_tp, tp),
                "rad": rad, "lam": lam, "em": em, "rng": rng,
                "radius": radius, "rays": rays,
            }
            if track_collapse:
                out["emh"] = emh
                out["coll"] = coll
            return out

        st = jax.lax.while_loop(cond, body, st)
        rays_ref[0] = st["rays"]

    return kernel


def regen_call(fscene, cfg, camera, planes, base_seed, spp, iteration,
               radius, tile_base, interpret, depth=None, aux=None):
    """Planes-level regenerative step: the raw pallas_call. Shared by the
    single-chip wrapper and the shard_map multi-chip step (tile_base = the
    device slab's global tile offset). Returns (planes, rays_per_tile).

    `aux` (f32 (3, TR, 128): per-lane budget / base count / SPPM radius,
    plane order) switches the kernel to budget mode — see
    _make_regen_kernel; the scalar spp/iteration/radius are then passed for
    signature symmetry only."""
    lanes = cfg.pallas_lanes
    R = lanes // 128
    if lanes % 128 or R & (R - 1):
        raise ValueError(f"cfg.pallas_lanes must be 128 times a power of "
                         f"two, got {lanes}")
    TR = planes.shape[1]
    if TR % R:
        raise ValueError(
            f"state rows {TR} not divisible by pallas tile rows {R}; "
            "init the state with cfg.backend='pallas'")
    n_tiles = TR // R
    # Two threads per lane: the fastest tiles of the lanes x warps sweep
    # (PERF.md). With as many lanes as threads the Triton compiler crashes
    # on the photon kernel, and a GPU program holds at most 32 warps.
    num_warps = lanes // 16
    if not interpret and num_warps > 32:
        raise ValueError(
            f"cfg.pallas_lanes={lanes} needs {num_warps} warps per program "
            "(two threads per lane); a GPU program holds at most 32, so "
            "compiled kernels take pallas_lanes <= 512")

    if cfg.motion_blur:
        from tpurt.camera import motion_rows
        cam = motion_rows(camera)                 # (8, 3): basis + deltas
    else:
        cam = jnp.stack([camera.origin, camera.horizontal,
                         camera.vertical, camera.lower_left])
    cam = jnp.pad(cam.astype(jnp.float32).reshape(-1),
                  (0, _CAM_LEN - cam.size))
    ip = jnp.stack([jnp.asarray(spp, jnp.int32),
                    jnp.asarray(iteration, jnp.int32),
                    jnp.asarray(cfg.depth if depth is None else depth,
                                jnp.int32),
                    jnp.asarray(tile_base, jnp.int32)])
    seed = jnp.asarray(base_seed, jnp.uint32).reshape(1)
    fp = jnp.stack([jnp.asarray(radius, jnp.float32),
                    jnp.asarray(iteration, jnp.int32).astype(jnp.float32)])
    sph_tab, tri_tab = _prim_tables(fscene, cfg)

    kernel = _make_regen_kernel(fscene, cfg, lanes,
                                budget_mode=aux is not None)
    vb = pl.BlockSpec((N_CHANNELS, R, 128), lambda i: (0, i, 0))
    whole = pl.BlockSpec()
    aux_args, aux_specs = (), []
    if aux is not None:
        aux_args = (aux,)
        aux_specs = [pl.BlockSpec((3, R, 128), lambda i: (0, i, 0))]
    new_planes, rays = pl.pallas_call(
        kernel,
        grid=(n_tiles,),
        in_specs=[vb] + [whole] * 6 + aux_specs,
        out_specs=[vb, pl.BlockSpec((1,), lambda i: (i,))],
        out_shape=[
            jax.ShapeDtypeStruct(planes.shape, jnp.float32),
            jax.ShapeDtypeStruct((n_tiles,), jnp.float32),
        ],
        input_output_aliases={0: 0},
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="regen_megakernel",
    )(planes, cam, ip, seed, fp, sph_tab, tri_tab, *aux_args)
    return new_planes, rays


def radius_after(cfg, iteration, radius, spp):
    """SPPM radius after `spp` more samples (same floats as the kernel's
    per-lane schedule, ref: mega_kernel.rs:196-198)."""
    def rstep(i, r):
        return sppm_radius_step(cfg, (iteration + i + 1).astype(jnp.float32),
                                r)
    return jax.lax.fori_loop(0, spp, rstep, radius)


@functools.partial(jax.jit,
                   static_argnames=("fscene", "cfg", "interpret"))
def _render_regen_jit(fscene, cfg, camera, state, base_seed, spp, interpret,
                      depth=None):
    # depth is DYNAMIC (None = cfg.depth): preview frames share the full
    # kernel's compile — the bound is a scalar input, not a constant
    planes = state_to_planes(state, cfg)
    new_planes, rays = regen_call(
        fscene, cfg, camera, planes, base_seed, spp, state.iteration,
        state.photon_radius, 0, interpret, depth=depth)

    P = new_planes.shape[1] * 128
    flat = planes_pixel_order(cfg, new_planes.reshape(N_CHANNELS, P))
    v3 = lambda a: jnp.stack([flat[a], flat[a + 1], flat[a + 2]], axis=-1)
    it_new = state.iteration + spp
    # final radius = schedule applied spp times (same floats as per-lane)
    r_new = radius_after(cfg, state.iteration, state.photon_radius, spp)
    return dataclasses.replace(
        state,
        rgb_sum=v3(0),
        n_samples=state.n_samples + spp.astype(jnp.float32),
        vis_pos=v3(3), vis_norm=v3(6), vis_wo=v3(9), vis_tp=v3(12),
        vis_mat=flat[15].astype(jnp.int32),
        iteration=it_new, photon_radius=r_new,
        rays=state.rays + jnp.sum(rays),
    )


def render_regen(scene, cfg: RenderConfig, camera, state, base_seed, spp,
                 depth: int | None = None):
    """Progressive render via the regenerative megakernel (full SPPM).
    Scene must be concrete and within the kernel's scope (check_scene
    raises otherwise). `depth` overrides cfg.depth (preview frames)."""
    check_scene(scene, cfg)
    fscene = freeze_scene(scene)
    return _render_regen_jit(fscene, cfg, camera, state,
                             jnp.asarray(base_seed, jnp.uint32),
                             jnp.asarray(spp, jnp.int32), pallas_interpret(),
                             # always a concrete scalar: a preview call
                             # (depth=1) and a full call then share ONE
                             # jit signature -> one compile
                             depth=jnp.asarray(
                                 cfg.depth if depth is None else depth,
                                 jnp.int32))


def budget_radius_plane(cfg, counts_f):
    """Per-pixel SPPM radius after counts_f samples, from the initial
    radius — the SAME float recurrence as radius_after (r *= the
    sppm_radius_step factor at 1-based indices 1..count), where-gated per
    pixel, so a uniform count reproduces the scalar schedule bit-for-bit."""
    kmax = jnp.max(counts_f).astype(jnp.int32)

    def rstep(i, r):
        fi = (i + 1).astype(jnp.float32)
        f = sppm_radius_step(cfg, fi, jnp.float32(1.0))
        return jnp.where(fi <= counts_f, r * f, r)

    r0 = jnp.full_like(counts_f, cfg.photon_radius_init)
    return jax.lax.fori_loop(0, kmax, rstep, r0)


@functools.partial(jax.jit,
                   static_argnames=("fscene", "cfg", "max_budget",
                                    "interpret"))
def _render_budget_regen_jit(fscene, cfg, camera, state, base_seed, budgets,
                             max_budget, interpret):
    P = state.rgb_sum.shape[0]
    TR = P // 128

    budgets = jnp.clip(budgets.astype(jnp.int32), 0, max_budget)
    budgets = jnp.where(jnp.arange(P) < cfg.n_pixels, budgets, 0)
    cnt_f = state.n_samples.astype(jnp.float32)
    rad0 = budget_radius_plane(cfg, cnt_f)
    aux = pixels_to_planes_order(
        cfg, jnp.stack([budgets.astype(jnp.float32), cnt_f, rad0]))
    aux = aux.reshape(3, TR, 128)

    planes = state_to_planes(state, cfg)
    new_planes, rays = regen_call(
        fscene, cfg, camera, planes, base_seed, 0, state.iteration,
        state.photon_radius, 0, interpret, aux=aux)

    flat = planes_pixel_order(cfg, new_planes.reshape(N_CHANNELS, P))
    v3 = lambda a: jnp.stack([flat[a], flat[a + 1], flat[a + 2]], axis=-1)
    # the scalar radius keeps the uniform schedule (advisory under
    # non-uniform counts — budget calls derive per-pixel radii from
    # n_samples, so chained budget renders stay exact)
    r_new = radius_after(cfg, state.iteration, state.photon_radius,
                         jnp.int32(max_budget))
    return dataclasses.replace(
        state,
        rgb_sum=v3(0),
        n_samples=state.n_samples + budgets.astype(jnp.float32),
        vis_pos=v3(3), vis_norm=v3(6), vis_wo=v3(9), vis_tp=v3(12),
        vis_mat=flat[15].astype(jnp.int32),
        iteration=state.iteration + jnp.int32(max_budget),
        photon_radius=r_new,
        rays=state.rays + jnp.sum(rays),
    )


def render_budget_regen(scene, cfg: RenderConfig, camera, state, base_seed,
                        budgets, max_budget: int):
    """Regenerative-megakernel render under a per-pixel budget map
    (adaptive sampling with the FULL estimator — photons included, unlike
    the wavefront budget renderers). Pixel p's k-th sample draws the
    standard per-(pixel, sample) streams and continues the pixel's own
    SPPM radius schedule, so estimates stay unbiased, a uniform budget
    reproduces render_regen bit-for-bit, and two chained budget calls
    equal one combined call."""
    from tpurt.render import _check_camera_kind   # deferred: import cycle
    _check_camera_kind(cfg, camera)
    check_scene(scene, cfg)
    fscene = freeze_scene(scene)
    return _render_budget_regen_jit(fscene, cfg, camera, state,
                                    jnp.asarray(base_seed, jnp.uint32),
                                    budgets, int(max_budget),
                                    pallas_interpret())
