"""The light-transport integrator: spectral path tracing with next-event
estimation plus the SPPM-style per-pixel photon pass.

This is the array-program rewrite of the reference mega kernel
(ref: src/kernels/mega_kernel.wgsl:568-1022).  The reference runs one scalar
thread per pixel with divergent `break`s; here a *tile* of pixels advances in
lockstep through masked, fixed-shape array ops:

  * per-pixel recursion        -> lax.fori_loop over a static bounce count
                                  with an `active` lane mask
  * divergent break/RR         -> mask updates (`jnp.where`)
  * material branching         -> both branches computed, per-lane select
                                  (material count is tiny; select is cheaper
                                  than divergence in lockstep lanes)
  * per-thread vispoint buffer -> a persistent (N, ...) pytree threaded
                                  through frames (reference never clears its
                                  vispoint buffer; neither do we)

Every function takes flat (N,) lane batches, so the identical code drives the
XLA path (render.py tiles the image) and the component-form fused kernel
(tpurt.kernels, the same formulas on per-lane planes).  RNG streams are bit-exact PCG (tpurt.ops.rng); draw
*order* differs from the scalar reference only where masking forces all lanes
to draw (distribution and independence are preserved, so images match within
Monte-Carlo noise, which is the parity contract from SURVEY.md §4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpurt.config import RenderConfig
from tpurt.ops import rng as rngmod
from tpurt.ops import soa
from tpurt.ops.bsdf import (
    INV_PI,
    abs_cos_theta,
    build_tangent_frame,
    cross,
    dot,
    effectively_smooth,
    fr_dielectric,
    normalize,
    oren_nayar_f,
    reflect_dir,
    refract_dir,
    roughness_to_alpha,
    same_hemisphere,
    to_local,
    to_world,
    tr_d,
    tr_g,
    tr_g1,
    tr_lambda,
    tr_sample_wm,
)
from tpurt.ops.intersect import (
    MISS,
    bvh_hit,
    closest_sphere_hit,
    closest_triangle_hit,
    combine_hits,
    shadow_attenuation,
)
from tpurt.ops.sampling import (
    PHOTON_CONE_COS,
    cone_from_u,
    cosine_hemisphere_from_u,
    sample_square_point,
)
from tpurt.ops.spectra import VISIBLE_RANGE, blackbody, cauchy_ior, cie_to_rgb

EPS = 1e-5  # ref: mega_kernel.wgsl:95
_HIT = MISS * 0.5  # any t below this is a real hit


def material_lookup(scene, mat_id):
    """Per-lane material attributes via one-hot matmul (gather-free; M is
    tiny so the (N, M) one-hot is cheap)."""
    M = scene.mat_color.shape[0]
    oh = (mat_id[:, None] == jnp.arange(M, dtype=jnp.int32)).astype(jnp.float32)
    # HIGHEST: a float32 matmul may otherwise run in TF32 (GPU) and round
    # the selected material attributes
    mm = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
    color = mm(oh, scene.mat_color)
    rough = mm(oh, scene.mat_rough)
    ior = mm(oh, scene.mat_ior)
    mtype = jnp.round(mm(oh, scene.mat_type.astype(jnp.float32))).astype(jnp.int32)
    return color, rough, ior, mtype


# Geometry-sharding hook (tpurt.parallel.geometry): when set (trace-time,
# inside a shard_map body), intersect_scene/_shadow results computed
# against the DEVICE-LOCAL triangle shard are combined across the mesh
# axis (nearest hit / min attenuation) right here, so every caller up the
# stack — NEE, camera loop, photon walk — sees globally-correct hits with
# no other code aware of the sharding. None = single-device (default).
_GEOM_HOOK = None


def intersect_scene(scene, cfg: RenderConfig, ray_o, ray_d):
    """Nearest hit against spheres + mesh (ref: mega_kernel.wgsl:874-878)."""
    hit = closest_sphere_hit(
        ray_o, ray_d, scene.sph_center, scene.sph_radius, scene.sph_mat,
        chunk=cfg.sphere_chunk,
    )
    if scene.num_triangles > 0:
        if cfg.use_bvh:
            tri = bvh_hit(ray_o, ray_d, scene.bvh_dict(),
                          max_leaf=scene.bvh_max_leaf)
        else:
            tri = closest_triangle_hit(
                ray_o, ray_d, scene.tri_a, scene.tri_e1, scene.tri_e2,
                scene.tri_n, scene.tri_mat, chunk=cfg.tri_chunk,
            )
        hit = combine_hits(hit, tri)
    if _GEOM_HOOK is not None:
        hit = _GEOM_HOOK.combine_hit(hit)
    return hit


def _shadow(scene, cfg, o, d, t_max, lam):
    atten = shadow_attenuation(
        o, d, t_max, lam,
        scene.sph_center, scene.sph_radius, scene.sph_mtype, scene.sph_ior,
        scene.tri_a, scene.tri_e1, scene.tri_e2,
        chunk=cfg.sphere_chunk, tri_chunk=cfg.tri_chunk,
    )
    if _GEOM_HOOK is not None:
        # the sphere factor is replicated (identical on every device) and
        # the local triangle term only ZEROES it, so the global
        # attenuation is exactly the mesh-wide minimum
        atten = _GEOM_HOOK.combine_shadow(atten)
    return atten


def light_emission_rgb(scene, lam):
    """Per-light spectral emission at this path's wavelength
    (ref: mega_kernel.wgsl:574-578): color*intensity * blackbody(lam,T) *
    cie_to_rgb(lam) * range. Lambda-invariant per path, so callers hoist it
    out of the bounce loop (the reference recomputes it per bounce)."""
    cie = cie_to_rgb(lam)  # (N, 3)
    out = []
    for i in range(scene.num_lights):
        lcol = scene.light_color[i]
        lint = scene.light_intensity[i]
        ltemp = scene.light_temp[i]
        spd = jnp.where(ltemp > 0.0, blackbody(lam, jnp.maximum(ltemp, 1.0)), 1.0)
        out.append(lcol[None, :] * lint * spd[:, None] * cie
                   * jnp.float32(VISIBLE_RANGE))
    return out


def sky_emission_rgb(cfg, lam):
    """Spectral environment emission at this path's wavelength (EXTENSION —
    the reference's sky returns black, mega_kernel.wgsl:617-620). Same form
    as light emission (wgsl :574-578) so the spectral estimator treats the
    sky as one more emitter: color*intensity * blackbody(lam, temp) *
    cie_to_rgb(lam) * range, with temp = 0 meaning a flat spectrum. Returns
    the WHITE (untinted) emission; callers multiply by cfg.sky_color (and
    the optional per-direction gradient tint) so hero tables stay
    direction-independent."""
    cie = cie_to_rgb(lam)  # (N, 3)
    temp = jnp.float32(cfg.sky_temp)
    spd = jnp.where(temp > 0.0, blackbody(lam, jnp.maximum(temp, 1.0)), 1.0)
    return jnp.float32(cfg.sky_intensity) * spd[:, None] * cie \
        * jnp.float32(VISIBLE_RANGE)


def _sky_tint(cfg, d):
    """Per-lane RGB tint of the sky: cfg.sky_color, lerped toward
    (.5,.7,1) by direction height when cfg.sky_gradient is also set
    (the legacy wavefront gradient's ramp, wavefront.wgsl:129-131)."""
    base = jnp.asarray(cfg.sky_color, jnp.float32)[None, :]
    if not cfg.sky_gradient:
        return base
    dn = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-30)
    t = 0.5 * (dn[:, 1:2] + 1.0)
    ramp = (1.0 - t) + t * jnp.asarray([0.5, 0.7, 1.0], jnp.float32)[None, :]
    return base * ramp


def sample_direct_lighting(scene, cfg, pos, norm, lam, rng, light_rgbs=None):
    """Next-event estimation over all lights (ref: mega_kernel.wgsl:568-615).

    Returns (rgb (N,3), rng). The loop over lights is a static Python loop
    (L is a compile-time constant); every lane draws the area-light 2f
    sample regardless of light type to stay branch-free. Callers count
    shadow segments themselves (active-diffuse lanes x num_lights — this
    function cannot see the caller's liveness mask). light_rgbs:
    precomputed light_emission_rgb(scene, lam) (computed here when None).
    """
    N = pos.shape[0]
    result = jnp.zeros((N, 3))
    if light_rgbs is None:
        light_rgbs = light_emission_rgb(scene, lam)

    if cfg.light_sample in ("power", "spatial") and scene.num_lights > 0:
        return _sample_direct_power(scene, cfg, pos, norm, lam, rng,
                                    light_rgbs)

    for i in range(scene.num_lights):
        lpos = scene.light_pos[i]
        lhw = scene.light_hw[i]
        ltype = scene.light_type[i]
        lnorm = scene.light_normal[i]
        light_rgb = light_rgbs[i]

        u, rng = rngmod.rand_2f(rng)
        is_area = ltype == 1

        # Target point: the light position, or a sampled point on the square.
        lp_area = sample_square_point(lpos, lhw, lnorm, u)  # (N, 3)
        lp = jnp.where(is_area, lp_area, jnp.broadcast_to(lpos, lp_area.shape))

        to_light = lp - pos
        dist = jnp.sqrt(jnp.maximum(dot(to_light, to_light), 1e-30))
        ldir = to_light / dist[:, None]
        ndotl = dot(norm, ldir)

        cos_light = jnp.maximum(0.0, jnp.sum(lnorm * (-ldir), axis=-1))
        geom_ok = (dist >= EPS) & (ndotl > 0.0) & jnp.where(is_area, cos_light > 0.0, True)
        area_ok = jnp.where(is_area, lhw > 0.0, True)
        live = geom_ok & area_ok

        so = pos + norm * EPS
        atten = _shadow(scene, cfg, so, ldir, dist - EPS, lam)

        inv_pdf = jnp.where(is_area, jnp.maximum(4.0 * lhw * lhw, 1e-10), 1.0)
        contrib = light_rgb * (ndotl * cos_light_or_one(is_area, cos_light)
                               * atten * inv_pdf / (dist * dist))[:, None]
        result = result + jnp.where(live[:, None], contrib, 0.0)
    return result, rng


def cos_light_or_one(is_area, cos_light):
    return jnp.where(is_area, cos_light, 1.0)


def _sample_direct_power(scene, cfg, pos, norm, lam, rng, light_rgbs):
    """cfg.light_sample == "power"/"spatial": ONE selected light per
    lane, weighted by 1/pmf (EXTENSION; the reference loops all lights).
    "power" selects by total emitted power; "spatial" additionally
    divides each weight by the lane's squared distance to the light
    center — the unshadowed-contribution heuristic, much lower variance
    when illumination is proximity-dominated. Draw layout: one select
    uniform, then the same 2f light sample as each "all"-mode light —
    every backend pairs up. Callers count ONE shadow segment per live
    lane (see render_tile)."""
    from tpurt.ops.sampling import (light_powers, select_chain,
                                    select_from_powers)
    L = scene.num_lights
    N = pos.shape[0]
    u_sel, rng = rngmod.rand_1f(rng)
    powers = light_powers(
        [scene.light_intensity[i] for i in range(L)],
        [scene.light_hw[i] for i in range(L)],
        [scene.light_type[i] == 1 for i in range(L)])
    if cfg.light_sample == "spatial":
        # per-lane 1/dist^2 to the light CENTER (selection must not
        # depend on the 2f sample drawn after it); floor keeps the pmf
        # bounded when a lane shades right next to a light
        sp = []
        for i in range(L):
            to = scene.light_pos[i][None, :] - pos
            d2 = jnp.sum(to * to, axis=-1)
            sp.append(powers[i] / jnp.maximum(d2, jnp.float32(1e-4)))
        powers = sp
    sels, inv_pmf = select_from_powers(u_sel, powers)
    lpos = select_chain(sels, [scene.light_pos[i][None, :] for i in range(L)])
    lnorm = select_chain(sels, [scene.light_normal[i][None, :]
                                for i in range(L)])
    lhw = select_chain(sels, [scene.light_hw[i] for i in range(L)])
    is_area = select_chain(
        sels, [(scene.light_type[i] == 1).astype(jnp.float32)
               for i in range(L)]) > 0.5
    light_rgb = select_chain(sels, light_rgbs)

    u, rng = rngmod.rand_2f(rng)
    lp_area = sample_square_point(lpos, lhw, lnorm, u)  # (N, 3)
    lp = jnp.where(is_area[:, None], lp_area, lpos)

    to_light = lp - pos
    dist = jnp.sqrt(jnp.maximum(dot(to_light, to_light), 1e-30))
    ldir = to_light / dist[:, None]
    ndotl = dot(norm, ldir)

    cos_light = jnp.maximum(0.0, jnp.sum(lnorm * (-ldir), axis=-1))
    geom_ok = (dist >= EPS) & (ndotl > 0.0) & jnp.where(
        is_area, cos_light > 0.0, True)
    area_ok = jnp.where(is_area, lhw > 0.0, True)
    live = geom_ok & area_ok

    so = pos + norm * EPS
    atten = _shadow(scene, cfg, so, ldir, dist - EPS, lam)

    inv_pdf = jnp.where(is_area, jnp.maximum(4.0 * lhw * lhw, 1e-10), 1.0)
    contrib = light_rgb * (ndotl * cos_light_or_one(is_area, cos_light)
                           * atten * inv_pdf * inv_pmf / (dist * dist))[:, None]
    return jnp.where(live[:, None], contrib, jnp.zeros((N, 3))), rng


# ----- Dielectric scattering -----

def _scatter_dielectric(wo, normal, eta, alpha, u2, u_choice, camera_pdf: bool):
    """Dielectric interaction, smooth + rough GGX, branch-free.

    camera_pdf=True uses the proper VNDF pdf of the camera path
    (ref: mega_kernel.wgsl:941-972); False uses the photon path's
    pdf = Lambda+1 approximation (wgsl :825-852). Returns
    (wi_world, tp_mult (N,), offset_along_normal (N,), valid (N,)).
    The 1/eta'^2 radiance scaling on transmission is folded into tp_mult.
    """
    # --- effectively smooth branch (wgsl :918-930) ---
    cos_t = dot(wo, normal)
    R_s = fr_dielectric(jnp.abs(cos_t), eta)
    reflect_s = u_choice < R_s
    wi_refl_s = reflect_dir(wo, normal)
    wi_refr_s, refr_ok = refract_dir(wo, normal, eta)
    etap_s = jnp.where(cos_t < 0.0, 1.0 / eta, eta)
    tp_refr_s = 1.0 / (etap_s * etap_s)
    wi_smooth = jnp.where(reflect_s[:, None], wi_refl_s, wi_refr_s)
    tp_smooth = jnp.where(reflect_s, 1.0, tp_refr_s)
    off_smooth = jnp.where(reflect_s, EPS, -EPS)
    valid_smooth = reflect_s | refr_ok

    # --- rough GGX branch (wgsl :931-973) ---
    T = build_tangent_frame(normal)
    B = cross(normal, T)
    wo_l = to_local(wo, normal, T, B)
    wm = tr_sample_wm(wo_l, u2, alpha)
    dot_wowm = jnp.abs(dot(wo_l, wm))
    R = fr_dielectric(dot_wowm, eta)
    Tns = 1.0 - R
    choose_reflect = u_choice < R / jnp.maximum(R + Tns, 1e-10)

    D = tr_d(wm, alpha)

    # reflect sub-branch
    wi_l_refl = reflect_dir(wo_l, wm)
    refl_ok = same_hemisphere(wo_l, wi_l_refl)
    G_r = tr_g(wo_l, wi_l_refl, alpha)
    ct_i_r = abs_cos_theta(wi_l_refl)
    ct_o = abs_cos_theta(wo_l)
    bsdf_r = D * G_r * R / jnp.maximum(4.0 * ct_i_r * ct_o, 1e-10)
    if camera_pdf:
        G1 = tr_g1(wo_l, alpha)
        pdf_wm = (G1 / jnp.maximum(ct_o, 1e-10)) * D * dot_wowm
        pdf_r = jnp.maximum(pdf_wm / jnp.maximum(4.0 * dot_wowm, 1e-10), 1e-10) \
            * (R / jnp.maximum(R + Tns, 1e-10))
    else:
        pdf_r = tr_lambda(wo_l, alpha) + 1.0
    tp_r = bsdf_r * ct_i_r / jnp.maximum(pdf_r, 1e-10)

    # transmit sub-branch
    wi_l_refr, refr_l_ok = refract_dir(wo_l, wm, eta)
    trans_ok = refr_l_ok & ~same_hemisphere(wo_l, wi_l_refr)
    G_t = tr_g(wo_l, wi_l_refr, alpha)
    ct_i_t = abs_cos_theta(wi_l_refr)
    denom = dot(wi_l_refr, wm) + dot(wo_l, wm) / eta
    bsdf_t = Tns * D * G_t * jnp.abs(
        dot(wi_l_refr, wm) * dot(wo_l, wm)
        / jnp.maximum(ct_i_t * ct_o * denom * denom, 1e-10)
    )
    if camera_pdf:
        dwm_dwi = jnp.abs(dot(wi_l_refr, wm)) / jnp.maximum(denom * denom, 1e-10)
        G1 = tr_g1(wo_l, alpha)
        pdf_t = jnp.maximum(
            (G1 / jnp.maximum(ct_o, 1e-10)) * D * dot_wowm * dwm_dwi
            * (Tns / jnp.maximum(R + Tns, 1e-10)),
            1e-10,
        )
    else:
        pdf_t = tr_lambda(wo_l, alpha) + 1.0
    etap_t = jnp.where(wo_l[..., 2] < 0.0, 1.0 / eta, eta)
    tp_t = bsdf_t * ct_i_t / jnp.maximum(pdf_t, 1e-10) / (etap_t * etap_t)

    wi_l = jnp.where(choose_reflect[:, None], wi_l_refl, wi_l_refr)
    wi_rough = to_world(wi_l, normal, T, B)
    tp_rough = jnp.where(choose_reflect, tp_r, tp_t)
    off_rough = jnp.where(choose_reflect, EPS, -EPS)
    valid_rough = jnp.where(choose_reflect, refl_ok, trans_ok)

    # --- select smooth vs rough per lane ---
    smooth = effectively_smooth(alpha)
    wi = jnp.where(smooth[:, None], wi_smooth, wi_rough)
    tp_mult = jnp.where(smooth, tp_smooth, tp_rough)
    offset = jnp.where(smooth, off_smooth, off_rough)
    valid = jnp.where(smooth, valid_smooth, valid_rough)
    return wi, tp_mult, offset, valid


def _scatter_metal(wo, normal, f0, alpha, u2, tangent_frame=None):
    """GGX conductor scatter (material type 2 — beyond the reference's two
    types, see scene.Material.metal). Smooth: mirror reflect, tp = Schlick F.
    Rough: VNDF sample, tp = F(wo.wm) * G2/G1 (the standard VNDF estimator
    weight). Returns (wi_world, tp_mult (N,3), offset (N,), valid (N,))."""
    from tpurt.ops.bsdf import fr_schlick

    # smooth branch
    cos_t = dot(wo, normal)
    wi_smooth = reflect_dir(wo, normal)
    tp_smooth = fr_schlick(cos_t, f0)
    valid_smooth = dot(wi_smooth, normal) * cos_t > 0.0

    # rough GGX branch
    T = build_tangent_frame(normal)
    B = cross(normal, T)
    wo_l = to_local(wo, normal, T, B)
    wm = tr_sample_wm(wo_l, u2, alpha)
    wi_l = reflect_dir(wo_l, wm)
    valid_r = same_hemisphere(wo_l, wi_l)
    F = fr_schlick(dot(wo_l, wm), f0)
    G2 = tr_g(wo_l, wi_l, alpha)
    G1 = tr_g1(wo_l, alpha)
    tp_rough = F * (G2 / jnp.maximum(G1, 1e-10))[:, None]
    wi_rough = to_world(wi_l, normal, T, B)

    smooth = effectively_smooth(alpha)
    wi = jnp.where(smooth[:, None], wi_smooth, wi_rough)
    tp = jnp.where(smooth[:, None], tp_smooth, tp_rough)
    valid = jnp.where(smooth, valid_smooth, valid_r)
    N = wo.shape[0]
    return wi, tp, jnp.full((N,), EPS), valid


def evaluate_bsdf(wo, wi, n, color, rough, ior, mtype, lam):
    """Photon-gather BSDF (ref: mega_kernel.wgsl:725-743): Oren-Nayar for
    diffuse; GGX *reflection only* for dielectrics (transmission ignored)."""
    f_diff = oren_nayar_f(wo, wi, n, color, rough)
    ndotv = dot(n, wo)
    ndotl = dot(n, wi)
    refl = ndotv * ndotl > 0.0
    alpha = roughness_to_alpha(rough)
    eta = cauchy_ior(ior, lam)
    wm = normalize(wi + wo, eps=1e-30)
    R = fr_dielectric(dot(wo, wm), eta)
    # tr_d/tr_lambda are defined in the local frame; the reference calls them
    # with world vectors here, relying on cosine terms w.r.t. +z. We mirror
    # that by projecting onto the surface frame first.
    T = build_tangent_frame(n)
    B = cross(n, T)
    wo_l = to_local(wo, n, T, B)
    wi_l = to_local(wi, n, T, B)
    wm_l = to_local(wm, n, T, B)
    D = tr_d(wm_l, alpha)
    G = tr_g(wo_l, wi_l, alpha)
    denom = jnp.maximum(4.0 * abs_cos_theta(wi_l) * abs_cos_theta(wo_l), 1e-10)
    spec = D * G * R / denom
    f_diel = jnp.where(refl, spec, 0.0)[:, None] * jnp.ones((1, 3))
    # metal (type 2): same GGX reflection lobe, Schlick RGB Fresnel
    from tpurt.ops.bsdf import fr_schlick
    F_m = fr_schlick(dot(wo, wm), color)
    f_metal = jnp.where(refl[:, None], F_m * (D * G / denom)[:, None], 0.0)
    f_spec = jnp.where((mtype == 2)[:, None], f_metal, f_diel)
    return jnp.where((mtype == 0)[:, None], f_diff, f_spec)


# ----- Camera path -----

def trace_camera_paths(scene, cfg: RenderConfig, ray_o, ray_d, lam, rng, depth: int,
                       vis_prev: dict, valid=None, strata_seed=None):
    """Trace one spectral sample per lane (ref: mega_kernel.wgsl:865-982).

    Returns (radiance (N,3), rng, vis (dict), ray_count (f32 scalar)).
    vis_prev carries last frame's vispoints; lanes that hit a diffuse surface
    this frame overwrite their entry (first diffuse bounce only).
    The bounce loop exits early once every lane in the tile is dead — safe
    for cross-backend parity because the photon pass draws from its own
    stream (rng.photon_stream), not a continuation of this one.
    """
    N = ray_o.shape[0]
    zero3 = jnp.zeros((N, 3))
    # Hero-wavelength sampling (cfg.hero_wavelengths > 1): the NEE emission
    # term averages the CIE responses of C rotated wavelengths sharing this
    # path; a lane collapses to the hero's response (at 1/C weight — the
    # other C-1 wavelengths transport zero past a dispersive vertex) on its
    # first dielectric camera interaction. C=1 reproduces the reference.
    C = max(1, int(cfg.hero_wavelengths))
    if C > 1:
        # folded periodic emission table: one small lerp instead of C full
        # CIE evaluations (see ops.spectra.hero_emission_table)
        from tpurt.ops.spectra import (hero_emission_lookup,
                                       hero_emission_table_jnp)
        light_rgbs = [hero_emission_lookup(
            hero_emission_table_jnp(scene.light_color[li],
                                    scene.light_intensity[li],
                                    scene.light_temp[li], C), C, lam)
            for li in range(scene.num_lights)]
        # post-collapse hero emission at FULL weight: only the hero
        # technique generates the dispersive dirac continuation (cf.
        # pbrt-v4 SampledWavelengths::TerminateSecondary) — no 1/C
        hero_rgbs = light_emission_rgb(scene, lam)
    else:
        light_rgbs = light_emission_rgb(scene, lam)  # lambda-invariant
    # collapse can only happen when the camera path is dispersive
    track_collapse = C > 1 and cfg.dispersion_in_camera_path

    # Environment emission (cfg.sky_intensity > 0): hoisted like the light
    # emissions; the direction-dependent tint is applied at miss time.
    sky_on = float(cfg.sky_intensity) > 0.0
    if sky_on:
        if C > 1:
            from tpurt.ops.spectra import (hero_emission_lookup,
                                           hero_emission_table_jnp)
            sky_rgb = hero_emission_lookup(
                hero_emission_table_jnp(jnp.ones((3,), jnp.float32),
                                        cfg.sky_intensity, cfg.sky_temp, C),
                C, lam)
        else:
            sky_rgb = sky_emission_rgb(cfg, lam)
        sky_hero = sky_emission_rgb(cfg, lam) if track_collapse else None

    # Type-3 emissive materials (EXTENSION, see Material.emissive): the
    # lambda-only emission base (cie * range; flat spectrum — intensity is
    # folded into the material color). Evaluated unconditionally (masked
    # math; scenes without emitters never set mtype 3). Hero-averaged like
    # the light/sky emissions.
    em_flat = cie_to_rgb(lam) * jnp.float32(VISIBLE_RANGE)
    if C > 1:
        from tpurt.ops.spectra import (hero_emission_lookup,
                                       hero_emission_table_jnp)
        em_avg = hero_emission_lookup(
            hero_emission_table_jnp(jnp.ones((3,), jnp.float32), 1.0, 0.0,
                                    C), C, lam)
    else:
        em_avg = em_flat

    active0 = jnp.ones((N,), bool) if valid is None else valid
    state = {
        "b": jnp.int32(0), "anylive": jnp.bool_(True),
        "o": ray_o, "d": ray_d,
        "tp": jnp.ones((N, 3)), "rad": zero3,
        "active": active0,
        "rng": rng,
        "vp_stored": jnp.zeros((N,), bool),
        "vis_pos": vis_prev["pos"], "vis_norm": vis_prev["norm"],
        "vis_wo": vis_prev["wo"], "vis_tp": vis_prev["tp"],
        "vis_mat": vis_prev["mat"],
        "rays": jnp.zeros((), jnp.float32),
    }
    if track_collapse:
        state["collapsed"] = jnp.zeros((N,), bool)

    def cond(st):
        return (st["b"] < depth) & st["anylive"]

    def bounce(st):
        o, d, tp, rad = st["o"], st["d"], st["tp"], st["rad"]
        active, rng = st["active"], st["rng"]

        if cfg.count_rays:
            st = {**st, "rays": st["rays"] + jnp.sum(active.astype(jnp.float32))}

        hit = intersect_scene(scene, cfg, o, d)
        found = hit["t"] < _HIT
        # Miss -> sky is black (ref: wgsl:617-620) unless the environment
        # emitter is on (cfg.sky_intensity); either way the lane dies.
        if sky_on:
            em = sky_rgb
            if track_collapse:
                em = jnp.where(st["collapsed"][:, None], sky_hero, sky_rgb)
            sky_add = tp * em * _sky_tint(cfg, d)
            rad = rad + jnp.where((active & ~found)[:, None], sky_add, 0.0)

        color, rough, ior, mtype = material_lookup(scene, hit["mat"])
        is_diffuse = mtype == 0
        is_em = mtype == 3
        wo = -d
        n = hit["normal"]
        loc = hit["loc"]

        # --- type-3 emitter hit: add emission, lane terminates below ---
        emb = em_avg
        if track_collapse:
            emb = jnp.where(st["collapsed"][:, None], em_flat, em_avg)
        rad = rad + jnp.where((active & found & is_em)[:, None],
                              tp * color * emb, 0.0)

        # --- vispoint store at first diffuse hit (wgsl :893-900) ---
        store = active & found & is_diffuse & ~st["vp_stored"]
        vis_pos = jnp.where(store[:, None], loc, st["vis_pos"])
        vis_norm = jnp.where(store[:, None], n, st["vis_norm"])
        vis_wo = jnp.where(store[:, None], wo, st["vis_wo"])
        vis_tp = jnp.where(store[:, None], tp, st["vis_tp"])
        vis_mat = jnp.where(store, hit["mat"], st["vis_mat"])
        vp_stored = st["vp_stored"] | store

        # --- NEE (diffuse lanes only consume the result) ---
        # (the returned live-geometry count is NOT added to the ray counter:
        # shadow segments are counted once below as lane_d * num_lights)
        if track_collapse:
            coll = st["collapsed"][:, None]
            rgbs = [jnp.where(coll, hero_rgbs[li], light_rgbs[li])
                    for li in range(scene.num_lights)]
        else:
            rgbs = light_rgbs
        direct, rng = sample_direct_lighting(scene, cfg, loc, n, lam, rng,
                                             light_rgbs=rgbs)
        nee = tp * color * direct
        lane_d = active & found & is_diffuse
        rad = rad + jnp.where(lane_d[:, None], nee, 0.0)
        if cfg.count_rays:
            # only diffuse lanes actually fire shadow rays in the reference;
            # power light sampling fires exactly one per lane instead of L
            # (and none at all on zero-light scenes — NEE is gated on L > 0)
            n_shadow = (min(1, scene.num_lights)
                        if cfg.light_sample != "all" else scene.num_lights)
            st_rays = st["rays"] + jnp.sum(lane_d.astype(jnp.float32)) * n_shadow
        else:
            st_rays = st["rays"]

        bs = None
        if cfg.photon_strata and cfg.camera_strata_bounce:
            bs = (strata_seed, rngmod.CAMERA_STRATA_K, st["b"])
        wi, new_tp, new_o, scat_ok, rr_live, rng = scatter_and_rr(
            cfg, wo, n, loc, color, rough, ior, mtype, lam, tp, rng,
            camera_path=True, bounce_strata=bs)

        cont = active & found & scat_ok & rr_live & ~is_em
        out = {
            "b": st["b"] + 1, "anylive": jnp.any(cont),
            "o": jnp.where(cont[:, None], new_o, o),
            "d": jnp.where(cont[:, None], wi, d),
            "tp": jnp.where(cont[:, None], new_tp, tp),
            "rad": rad,
            "active": cont,
            "rng": rng,
            "vp_stored": vp_stored,
            "vis_pos": vis_pos, "vis_norm": vis_norm,
            "vis_wo": vis_wo, "vis_tp": vis_tp, "vis_mat": vis_mat,
            "rays": st_rays,
        }
        if track_collapse:
            # a dielectric interaction steers the path by eta(lambda):
            # only the hero transports onward (Wilkie et al. 2014 dirac case)
            is_dielectric = ~(is_diffuse | (mtype == 2) | is_em)
            out["collapsed"] = st["collapsed"] | \
                (active & found & is_dielectric)
        return out

    state = jax.lax.while_loop(cond, bounce, state)
    vis = {
        "pos": state["vis_pos"], "norm": state["vis_norm"],
        "wo": state["vis_wo"], "tp": state["vis_tp"], "mat": state["vis_mat"],
    }
    return state["rad"], state["rng"], vis, state["rays"]


# ----- Photon pass -----


def scatter_and_rr(cfg: RenderConfig, wo, n, loc, color, rough, ior, mtype,
                   lam, tp, rng, camera_path: bool, bounce_strata=None):
    """Shared scatter + Russian roulette step — draw order u2 (2f),
    u_choice, u_rr (wgsl :906-979 camera / :782-858 photon). Used by the
    camera bounce loop, the photon walk, and the wavefront sweep so the
    physics and the RNG lattice cannot drift apart. camera_path selects
    the VNDF pdf mode, the reference's base-IOR camera quirk
    (dispersion_in_camera_path), and the RR threshold.
    bounce_strata: (strata_seed, k, bounce) — photon-walk callers pass it
    under cfg.photon_strata_bounce to remap (u2, u_choice) into the
    tile-shared bounce cell (rng.apply_bounce_strata); u_rr never remaps.
    Returns (wi, new_tp, new_o, scat_ok, rr_live, rng)."""
    u2, rng = rngmod.rand_2f(rng)
    u_choice, rng = rngmod.rand_1f(rng)
    u_rr, rng = rngmod.rand_1f(rng)
    if bounce_strata is not None:
        b_seed, b_k, b_bounce = bounce_strata
        u2a, u2b, u_choice = rngmod.apply_bounce_strata(
            b_seed, b_k, b_bounce, rngmod.strata_counts(cfg)[1],
            u2[..., 0], u2[..., 1], u_choice)
        u2 = jnp.stack([u2a, u2b], axis=-1)

    # diffuse: cosine scatter + Oren-Nayar (wgsl :906-912)
    rn = rngmod.unit_vec_from_u(u2)
    wi_d = normalize(n + rn, eps=1e-30)
    cosw = jnp.maximum(dot(n, wi_d), 1e-10)
    pdf_d = cosw * jnp.float32(INV_PI)
    f_diff = oren_nayar_f(normalize(wo, eps=1e-30), wi_d, n, color, rough)
    tpm_d = f_diff * (cosw / jnp.maximum(pdf_d, 1e-10))[:, None]

    # dielectric (wgsl :914-973) / metal (extension)
    if camera_path and not cfg.dispersion_in_camera_path:
        eta = ior  # reference quirk: base IOR on the camera path (:915)
    else:
        eta = cauchy_ior(ior, lam)  # photons always disperse (:797)
    alpha = roughness_to_alpha(rough)
    wi_s, tpm_s, off_s, valid_s = _scatter_dielectric(
        wo, n, eta, alpha, u2, u_choice, camera_pdf=camera_path
    )
    wi_m, tpm_m, off_m, valid_m = _scatter_metal(wo, n, color, alpha, u2)

    is_diffuse = mtype == 0
    is_metal = mtype == 2
    wi = jnp.where(is_diffuse[:, None], wi_d,
                   jnp.where(is_metal[:, None], wi_m, wi_s))
    tpm = jnp.where(is_diffuse[:, None], tpm_d,
                    jnp.where(is_metal[:, None], tpm_m,
                              tpm_s[:, None] * jnp.ones((1, 3))))
    off = jnp.where(is_diffuse, EPS, jnp.where(is_metal, off_m, off_s))
    scat_ok = is_diffuse | jnp.where(is_metal, valid_m, valid_s)

    new_tp = tp * tpm
    new_o = loc + n * off[:, None]

    # Russian roulette (wgsl :976-979 / :855-858)
    prob = jnp.max(new_tp, axis=-1)
    thr = cfg.rr_threshold if camera_path else cfg.photon_rr_threshold
    scale = 1.0 if camera_path else cfg.photon_rr_scale
    if scale == 1.0:
        rr_live = (prob >= thr) & (u_rr <= prob)
        new_tp = new_tp / jnp.maximum(prob, 1e-30)[:, None]
    else:
        # EXTENSION (cfg.photon_rr_scale): extra thinning COMPOSED with
        # the reference's own RR — survive with min(prob,1)*s, reweight
        # by 1/(prob*s). Expectation per bounce equals the reference's
        # (tpm*min(prob,1)/prob) for EVERY prob, including the prob > 1
        # regime where the reference normalizes tp down with certain
        # survival (photon tp starts at light_power/k >> 1); a clamped
        # min(s*prob,1) kill would instead lengthen those walks.
        p = jnp.minimum(prob, jnp.float32(1.0)) * jnp.float32(scale)
        rr_live = (prob >= thr) & (u_rr <= p)
        new_tp = new_tp / jnp.maximum(prob * jnp.float32(scale),
                                      1e-30)[:, None]
    return wi, new_tp, new_o, scat_ok, rr_live, rng


def trace_photons(scene, cfg: RenderConfig, lam, seed, px, py, vis,
                  photon_radius, valid=None, strata_seed=None):
    """Per-pixel SPPM photon pass (ref: mega_kernel.wgsl:745-861, 998-1015).

    Each lane owns one vispoint; K_PHOTONS photons are emitted round-robin
    over the lights and contribute density-estimated radiance when they land
    within photon_radius of the lane's vispoint. Every photon k draws from
    its own stream rng.photon_stream(seed, px, py, k) — see that docstring.
    Returns (contrib (N,3), ray_count).
    """
    N = lam.shape[0]
    L = scene.num_lights
    contrib = jnp.zeros((N, 3))
    rays = jnp.zeros((), jnp.float32)
    if L == 0 or not cfg.enable_photons:
        return contrib, rays

    vp_ok = jnp.sqrt(dot(vis["pos"], vis["pos"])) > 0.001  # (N,)
    if valid is not None:
        vp_ok = vp_ok & valid
    v_color, v_rough, v_ior, v_mtype = material_lookup(scene, vis["mat"])

    for k in range(cfg.k_photons):
        rng = rngmod.photon_stream(seed, px, py, k)
        li = k % L
        lpos = scene.light_pos[li]
        lhw = scene.light_hw[li]
        lcol = scene.light_color[li]
        lint = scene.light_intensity[li]
        ltype = scene.light_type[li]
        lnorm = scene.light_normal[li]
        light_power = lcol * lint  # (3,)

        # emission uniforms, reference draw order: cone 1f + 2f (second
        # component drawn-unused), quad position 2f, hemisphere 2f
        uc, rng = rngmod.rand_1f(rng)
        u_cone, rng = rngmod.rand_2f(rng)
        up1 = u_cone[..., 0]
        u_emit, rng = rngmod.rand_2f(rng)
        ue1, ue2 = u_emit[..., 0], u_emit[..., 1]
        u_dir, rng = rngmod.rand_2f(rng)
        uh1, uh2 = u_dir[..., 0], u_dir[..., 1]
        if cfg.photon_strata:
            # tile-coherent stratification (EXTENSION): remap into one
            # hash-chosen cell per (sample, k), shared by every pixel —
            # the same helper the megakernels call
            uc, up1, ue1, ue2, uh1, uh2 = rngmod.apply_emission_strata(
                seed if strata_seed is None else strata_seed,
                rngmod.strata_k(cfg, k), *rngmod.strata_counts(cfg),
                uc, up1, ue1, ue2, uh1, uh2)

        is_point = ltype == 0
        # Point light: cone toward origin
        origin_b = jnp.broadcast_to(lpos, (N, 3))
        d_cone = cone_from_u(origin_b, jnp.zeros((N, 3)), uc, up1)
        cone_factor = (1.0 - PHOTON_CONE_COS) * 0.5
        tp_point = light_power / cfg.k_photons * cone_factor
        # Area light: square point + cosine dir about the light normal
        lp = sample_square_point(lpos, lhw, lnorm,
                                 jnp.stack([ue1, ue2], axis=-1))  # (N,3)
        d_cos = cosine_hemisphere_from_u(
            jnp.broadcast_to(lnorm, (N, 3)), uh1, uh2)
        tp_area = light_power / cfg.k_photons

        if cfg.photon_aim > 0.0:
            # EXTENSION cfg.photon_aim: importance-aim the area-light
            # emission at the lane's own vispoint (defensive mixture; see
            # ops/soa.aimed_cone_c). 3 extra draws AFTER the reference
            # layout so flag-off streams are untouched; drawn for every k
            # (point-light ks too) to keep the stream layout uniform — the
            # weight only ever touches the area branch.
            uch, rng = rngmod.rand_1f(rng)
            u_aim, rng = rngmod.rand_2f(rng)
            q_lane = jnp.where(vp_ok, jnp.float32(cfg.photon_aim),
                               jnp.float32(0.0))
            o_aim = lp + lnorm * EPS  # the photon origin (= ph_o below)
            o_c = (o_aim[..., 0], o_aim[..., 1], o_aim[..., 2])
            vp_c = (vis["pos"][..., 0], vis["pos"][..., 1],
                    vis["pos"][..., 2])
            d_aim, ax, cos_a = soa.aimed_cone_c(
                o_c, vp_c, photon_radius,
                jnp.float32(cfg.photon_aim_widen),
                u_aim[..., 0], u_aim[..., 1])
            choose = (uch < q_lane)[..., None]
            d_cos = jnp.where(choose, jnp.stack(d_aim, axis=-1), d_cos)
            d_c = (d_cos[..., 0], d_cos[..., 1], d_cos[..., 2])
            aim_w = soa.aim_mixture_weight_c(
                d_c, (lnorm[0], lnorm[1], lnorm[2]), ax, cos_a, q_lane)
            tp_area = tp_area * aim_w[..., None]

        ph_o = jnp.where(is_point, origin_b, lp + lnorm * EPS)
        ph_d = jnp.where(is_point, d_cone, d_cos)
        ph_tp = jnp.broadcast_to(jnp.where(is_point, tp_point, tp_area), (N, 3))

        st = {
            "b": jnp.int32(0), "anylive": jnp.any(vp_ok),
            "o": ph_o, "d": ph_d, "tp": ph_tp,
            "active": vp_ok, "rng": rng,
            "contrib": jnp.zeros((N, 3)),
            "rays": jnp.zeros((), jnp.float32),
        }

        def ph_cond(st):
            return (st["b"] < cfg.max_photon_bounces) & st["anylive"]

        def ph_bounce(st):
            o, d, tp, active, rng = st["o"], st["d"], st["tp"], st["active"], st["rng"]
            if cfg.count_rays:
                st = {**st, "rays": st["rays"] + jnp.sum(active.astype(jnp.float32))}

            hit = intersect_scene(scene, cfg, o, d)
            found = hit["t"] < _HIT
            live = active & found

            # density estimation against this lane's vispoint (wgsl :774-780)
            dvec = hit["loc"] - vis["pos"]
            dist = jnp.sqrt(jnp.maximum(dot(dvec, dvec), 0.0))
            near = dist < photon_radius
            f = evaluate_bsdf(vis["wo"], -d, vis["norm"],
                              v_color, v_rough, v_ior, v_mtype, lam)
            kern = 1.0 - dist / photon_radius
            dens = vis["tp"] * f * tp * (kern / jnp.maximum(
                jnp.float32(3.14159265358979) * photon_radius * photon_radius, 1e-10))[:, None]
            add = jnp.where((live & near)[:, None], dens, 0.0)
            c = st["contrib"] + add

            # scatter (wgsl :782-853)
            color, rough, ior, mtype = material_lookup(scene, hit["mat"])
            is_diffuse = mtype == 0
            wo = -d
            n = hit["normal"]

            bs = None
            if cfg.photon_strata and cfg.photon_strata_bounce:
                bs = (seed if strata_seed is None else strata_seed,
                      rngmod.strata_k(cfg, k), st["b"])
            wi, new_tp, new_o, scat_ok, rr_live, rng = scatter_and_rr(
                cfg, wo, n, hit["loc"], color, rough, ior, mtype, lam, tp,
                rng, camera_path=False, bounce_strata=bs)

            # type-3 emitters absorb photons (they emit, never reflect)
            cont = live & scat_ok & rr_live & (mtype != 3)
            return {
                "b": st["b"] + 1, "anylive": jnp.any(cont),
                "o": jnp.where(cont[:, None], new_o, o),
                "d": jnp.where(cont[:, None], wi, d),
                "tp": jnp.where(cont[:, None], new_tp, tp),
                "active": cont, "rng": rng,
                "contrib": c, "rays": st["rays"],
            }

        st = jax.lax.while_loop(ph_cond, ph_bounce, st)
        contrib = contrib + st["contrib"]
        rays = rays + st["rays"]

    return contrib, rays


# ----- Per-tile frame sample -----

def render_tile(scene, cfg: RenderConfig, camera, px, py, seed, photon_radius,
                depth: int, vis_prev: dict, valid=None, strata_seed=None,
                qmc_ctx=None):
    """One progressive sample for a tile of pixels (= one reference frame's
    work for those pixels, ref: mega_kernel.wgsl:984-1021).

    px, py: integer pixel coords (N,). valid: optional (N,) bool marking
    real pixels — padding lanes (pixel-count round-up) stay inactive so the
    traced-segment counter is exact. Returns (color (N,3), vis, ray_count).
    Accumulation (+= color, count += 1) happens in the caller.
    qmc_ctx: (base_seed, global_sample_index), required when cfg.qmc —
    the spawn draws then come from the Owen-scrambled Sobol stream.
    """
    rng = rngmod.seed_pixels(seed, px, py)

    # cfg.qmc: spawn draws from the low-discrepancy stream; the path and
    # photon PCG streams are untouched (they start at position 0 instead
    # of after the spawn draws — shifted identically in every backend, so
    # cross-backend pairing holds either way)
    if cfg.qmc:
        if qmc_ctx is None:
            raise ValueError("cfg.qmc=True requires qmc_ctx="
                             "(base_seed, global_sample_index)")
        from tpurt.ops import qmc as qmcmod
        src = qmcmod.spawn_stream(qmc_ctx[0], qmc_ctx[1], px, py)
    else:
        src = rng

    u_jit, src = rngmod.rand_2f(src)
    u = (px.astype(jnp.float32) + u_jit[:, 0]) / jnp.float32(cfg.width)
    v = (py.astype(jnp.float32) + u_jit[:, 1]) / jnp.float32(cfg.height)
    from tpurt.camera import spawn_camera_rays
    ray_o, ray_d, src = spawn_camera_rays(cfg, camera, u, v, src)

    u_lam, src = rngmod.rand_1f(src)
    if not cfg.qmc:
        rng = src
    from tpurt.ops.spectra import sample_wavelength
    lam = sample_wavelength(u_lam)

    rad, rng, vis, rays = trace_camera_paths(
        scene, cfg, ray_o, ray_d, lam, rng, depth, vis_prev, valid=valid,
        strata_seed=seed if strata_seed is None else strata_seed,
    )
    # Independent per-photon streams (see rng.photon_stream): draw
    # positions depend only on (pixel, sample, k), never on tile geometry
    # or early exits — all backends stay same-seed comparable.
    ph, prays = trace_photons(scene, cfg, lam, seed, px, py, vis,
                              photon_radius, valid=valid,
                              strata_seed=strata_seed)
    return rad + ph, vis, rays + prays
