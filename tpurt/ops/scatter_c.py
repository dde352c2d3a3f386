"""Component-form BSDF sampling and evaluation.

The scatter routines of the fused kernel (tpurt.kernels.mega_regen) in
component form: every vector is a tuple of three same-shaped planes (see
tpurt.ops.soa), so the same code runs on a kernel's per-lane planes and on
flat arrays in tests. They mirror the XLA integrator's (N, 3) versions in
tpurt.integrate and tpurt.ops.bsdf (ref: mega_kernel.wgsl:906-973 camera,
:782-852 photon, :725-743 photon gather).
"""

from __future__ import annotations

import jax.numpy as jnp

from tpurt.ops import soa as s
from tpurt.ops.bsdf import INV_PI, fr_dielectric

EPS = 1e-5  # hit-point offset along the normal (ref: mega_kernel.wgsl)


def schlick_c(cos_t, f0):
    """Schlick Fresnel, component form; f0 vec3 tuple, cos (R,128)."""
    c = jnp.clip(jnp.abs(cos_t), 0.0, 1.0)
    m = 1.0 - c
    w = m * m * m * m * m
    return tuple(f0[i] + (1.0 - f0[i]) * w for i in range(3))


def scatter_metal_c(wo, normal, f0, alpha, u2a, u2b):
    """GGX conductor scatter (material type 2; see scene.Material.metal).
    Smooth: mirror + Schlick F. Rough: VNDF sample, tp = F * G2/G1.
    Returns (wi, tp (vec3), valid)."""
    cos_t = s.vdot(wo, normal)
    wi_sm = s.reflect_c(wo, normal)
    tp_sm = schlick_c(cos_t, f0)
    valid_sm = s.vdot(wi_sm, normal) * cos_t > 0.0

    T = s.build_tangent_frame_c(normal)
    B = s.vcross(normal, T)
    wo_l = s.to_local_c(wo, normal, T, B)
    wm = s.tr_sample_wm_c(wo_l, u2a, u2b, alpha)
    wi_l = s.reflect_c(wo_l, wm)
    valid_r = wo_l[2] * wi_l[2] > 0.0
    F = schlick_c(s.vdot(wo_l, wm), f0)
    G2 = s.tr_g_c(wo_l[2], wi_l[2], alpha)
    G1 = s.tr_g1_c(wo_l[2], alpha)
    w = G2 / jnp.maximum(G1, 1e-10)
    tp_r = s.vscale(F, w)
    wi_rough = s.to_world_c(wi_l, normal, T, B)

    smooth = alpha < 1e-3
    wi = s.vwhere(smooth, wi_sm, wi_rough)
    tp = s.vwhere(smooth, tp_sm, tp_r)
    valid = (smooth & valid_sm) | (~smooth & valid_r)
    return wi, tp, valid


def scatter_dielectric_c(wo, normal, eta, alpha, u2a, u2b, u_choice, camera_pdf):
    """Component-form mirror of tpurt.integrate._scatter_dielectric
    (ref: mega_kernel.wgsl:914-973 camera, :795-852 photon).

    camera_pdf: True/False selects the camera path's VNDF pdf vs the photon
    path's Lambda+1 approximation statically; a per-lane MASK computes both
    pdf variants (the only terms that differ) and selects — the regenerative
    kernel uses this so mixed camera/photon lanes share one scatter pass."""
    # --- effectively smooth ---
    cos_t = s.vdot(wo, normal)
    R_s = fr_dielectric(jnp.abs(cos_t), eta)
    reflect_s = u_choice < R_s
    wi_refl_s = s.reflect_c(wo, normal)
    wi_refr_s, refr_ok = s.refract_c(wo, normal, eta)
    etap_s = jnp.where(cos_t < 0.0, 1.0 / eta, eta)
    tp_refr_s = 1.0 / (etap_s * etap_s)
    wi_smooth = s.vwhere(reflect_s, wi_refl_s, wi_refr_s)
    tp_smooth = jnp.where(reflect_s, 1.0, tp_refr_s)
    off_smooth = jnp.where(reflect_s, EPS, -EPS)
    valid_smooth = reflect_s | refr_ok

    # --- rough GGX ---
    T = s.build_tangent_frame_c(normal)
    B = s.vcross(normal, T)
    wo_l = s.to_local_c(wo, normal, T, B)
    wm = s.tr_sample_wm_c(wo_l, u2a, u2b, alpha)
    dot_wowm = jnp.abs(s.vdot(wo_l, wm))
    R = fr_dielectric(dot_wowm, eta)
    Tns = 1.0 - R
    choose_reflect = u_choice < R / jnp.maximum(R + Tns, 1e-10)

    D = s.tr_d_c(wm[2], alpha)

    wi_l_refl = s.reflect_c(wo_l, wm)
    refl_ok = wo_l[2] * wi_l_refl[2] > 0.0
    G_r = s.tr_g_c(wo_l[2], wi_l_refl[2], alpha)
    ct_i_r = jnp.abs(wi_l_refl[2])
    ct_o = jnp.abs(wo_l[2])
    bsdf_r = D * G_r * R / jnp.maximum(4.0 * ct_i_r * ct_o, 1e-10)
    static_pdf = isinstance(camera_pdf, bool)
    if (not static_pdf) or camera_pdf:
        G1 = s.tr_g1_c(wo_l[2], alpha)
        pdf_wm = (G1 / jnp.maximum(ct_o, 1e-10)) * D * dot_wowm
        pdf_r_cam = jnp.maximum(pdf_wm / jnp.maximum(4.0 * dot_wowm, 1e-10),
                                1e-10) * (R / jnp.maximum(R + Tns, 1e-10))
    if (not static_pdf) or not camera_pdf:
        pdf_r_ph = s.tr_lambda_c(wo_l[2], alpha) + 1.0
    if static_pdf:
        pdf_r = pdf_r_cam if camera_pdf else pdf_r_ph
    else:
        pdf_r = jnp.where(camera_pdf, pdf_r_cam, pdf_r_ph)
    tp_r = bsdf_r * ct_i_r / jnp.maximum(pdf_r, 1e-10)

    wi_l_refr, refr_l_ok = s.refract_c(wo_l, wm, eta)
    trans_ok = refr_l_ok & ~(wo_l[2] * wi_l_refr[2] > 0.0)
    G_t = s.tr_g_c(wo_l[2], wi_l_refr[2], alpha)
    ct_i_t = jnp.abs(wi_l_refr[2])
    denom = s.vdot(wi_l_refr, wm) + s.vdot(wo_l, wm) / eta
    bsdf_t = Tns * D * G_t * jnp.abs(
        s.vdot(wi_l_refr, wm) * s.vdot(wo_l, wm)
        / jnp.maximum(ct_i_t * ct_o * denom * denom, 1e-10)
    )
    if (not static_pdf) or camera_pdf:
        dwm_dwi = jnp.abs(s.vdot(wi_l_refr, wm)) / jnp.maximum(denom * denom, 1e-10)
        G1 = s.tr_g1_c(wo_l[2], alpha)
        pdf_t_cam = jnp.maximum(
            (G1 / jnp.maximum(ct_o, 1e-10)) * D * dot_wowm * dwm_dwi
            * (Tns / jnp.maximum(R + Tns, 1e-10)),
            1e-10,
        )
    if (not static_pdf) or not camera_pdf:
        pdf_t_ph = s.tr_lambda_c(wo_l[2], alpha) + 1.0
    if static_pdf:
        pdf_t = pdf_t_cam if camera_pdf else pdf_t_ph
    else:
        pdf_t = jnp.where(camera_pdf, pdf_t_cam, pdf_t_ph)
    etap_t = jnp.where(wo_l[2] < 0.0, 1.0 / eta, eta)
    tp_t = bsdf_t * ct_i_t / jnp.maximum(pdf_t, 1e-10) / (etap_t * etap_t)

    wi_l = s.vwhere(choose_reflect, wi_l_refl, wi_l_refr)
    wi_rough = s.to_world_c(wi_l, normal, T, B)
    tp_rough = jnp.where(choose_reflect, tp_r, tp_t)
    off_rough = jnp.where(choose_reflect, EPS, -EPS)
    valid_rough = (choose_reflect & refl_ok) | (~choose_reflect & trans_ok)

    smooth = alpha < 1e-3
    wi = s.vwhere(smooth, wi_smooth, wi_rough)
    tp_mult = jnp.where(smooth, tp_smooth, tp_rough)
    offset = jnp.where(smooth, off_smooth, off_rough)
    valid = (smooth & valid_smooth) | (~smooth & valid_rough)
    return wi, tp_mult, offset, valid


def evaluate_bsdf_c(wo, wi, n, color, rough, ior_eta, is_diff, is_metal):
    """Photon-gather BSDF (wgsl :725-743): Oren-Nayar diffuse or
    GGX-reflection-only dielectric/metal. ior_eta is the pre-dispersed eta."""
    f_diff = s.oren_nayar_c(wo, wi, n, color, rough)
    ndotv = s.vdot(n, wo)
    ndotl = s.vdot(n, wi)
    refl = ndotv * ndotl > 0.0
    alpha = jnp.sqrt(rough)
    wm = s.vnormalize(s.vadd(wi, wo), eps=1e-30)
    R = fr_dielectric(s.vdot(wo, wm), ior_eta)
    T = s.build_tangent_frame_c(n)
    B = s.vcross(n, T)
    wo_l = s.to_local_c(wo, n, T, B)
    wi_l = s.to_local_c(wi, n, T, B)
    wm_l = s.to_local_c(wm, n, T, B)
    D = s.tr_d_c(wm_l[2], alpha)
    G = s.tr_g_c(wo_l[2], wi_l[2], alpha)
    denom = jnp.maximum(4.0 * jnp.abs(wi_l[2]) * jnp.abs(wo_l[2]), 1e-10)
    spec = jnp.where(refl, D * G * R / denom, 0.0)
    # metal: same lobe, Schlick RGB Fresnel (color = F0)
    F_m = schlick_c(s.vdot(wo, wm), color)
    dg = jnp.where(refl, D * G / denom, 0.0)
    f_metal = s.vscale(F_m, dg)
    f_spec = s.vwhere(is_metal, f_metal, (spec, spec, spec))
    return s.vwhere(is_diff, f_diff, f_spec)


def diffuse_scatter_c(wo, n, color, rough, u2a, u2b):
    """Cosine scatter + Oren-Nayar throughput (wgsl :906-912)."""
    rn = s.unit_vec_from_u_c(u2a, u2b)
    wi_d = s.vnormalize(s.vadd(n, rn), eps=1e-30)
    cosw = jnp.maximum(s.vdot(n, wi_d), 1e-10)
    pdf_d = cosw * jnp.float32(INV_PI)
    f_diff = s.oren_nayar_c(s.vnormalize(wo, eps=1e-30), wi_d, n, color, rough)
    tpm_d = s.vscale(f_diff, cosw / jnp.maximum(pdf_d, 1e-10))
    return wi_d, tpm_d
