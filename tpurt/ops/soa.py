"""Component-form (structure-of-arrays) physics for Pallas kernels.

The XLA integrator (tpurt.integrate) carries vectors as (N, 3) arrays, which
XLA lays out freely.  Inside a Pallas kernel the layout is ours to choose, and
a (N, 3) array would pad or stride its last axis.  So kernels represent a
vec3 as a *tuple of three (R, 128) planes* — one lane per pixel, every op
dense with zero padding.

This module is the component-form mirror of tpurt.ops.{bsdf,sampling,spectra,
intersect}: identical formulas (same reference citations apply, see those
modules — ultimately ref: src/kernels/mega_kernel.wgsl), different data
layout.  Functions here are plain jnp on arrays of any shape, so they also
run outside Pallas (the kernel-vs-XLA parity tests rely on this).

Scalar-polymorphic helpers (fr_dielectric, blackbody, cauchy_ior, the PCG
RNG) are NOT duplicated — kernels import them from their home modules.
"""

from __future__ import annotations

import jax.numpy as jnp

from tpurt.ops.bsdf import INV_PI, PI, TWO_PI, fr_dielectric  # noqa: F401
from tpurt.ops.spectra import (CIE_RGB_TABLE, CIE_STEP, N_CIE, VISIBLE_MIN,
                               cauchy_ior)

# ----- vec3 as a tuple of planes -----

def v3(x, y, z):
    return (x, y, z)


def vbroadcast(scalar3, like):
    """Broadcast a (3,)-indexable of scalars against a template plane."""
    one = jnp.ones_like(like)
    return (scalar3[0] * one, scalar3[1] * one, scalar3[2] * one)


def vadd(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def vsub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def vmul(a, b):
    """Elementwise (Hadamard) product of two vec3s."""
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def vscale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def vneg(a):
    return (-a[0], -a[1], -a[2])


def vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def vcross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def vnormalize(a, eps=0.0):
    inv = 1.0 / jnp.sqrt(jnp.maximum(vdot(a, a), eps))
    return vscale(a, inv)


def vwhere(m, a, b):
    return (
        jnp.where(m, a[0], b[0]),
        jnp.where(m, a[1], b[1]),
        jnp.where(m, a[2], b[2]),
    )


def vmax_comp(a):
    return jnp.maximum(jnp.maximum(a[0], a[1]), a[2])


def vlength(a):
    return jnp.sqrt(vdot(a, a))


# ----- shading frames (ref: mega_kernel.wgsl:677-681) -----

def build_tangent_frame_c(n):
    """T = normalize(cross(+Y, n)) = normalize((nz, 0, -nx)); +X if n ~ +/-Y."""
    t_raw = vnormalize((n[2], jnp.zeros_like(n[2]), -n[0]), eps=1e-30)
    near_y = jnp.abs(n[1]) > 0.99999
    one = jnp.ones_like(n[0])
    zero = jnp.zeros_like(n[0])
    return vwhere(near_y, (one, zero, zero), t_raw)


def to_local_c(w, n, t, b):
    return (vdot(w, t), vdot(w, b), vdot(w, n))


def to_world_c(w, n, t, b):
    return vadd(vadd(vscale(t, w[0]), vscale(b, w[1])), vscale(n, w[2]))


# ----- uniform sphere direction (ref: mega_kernel.wgsl:670-675) -----

def unit_vec_from_u_c(u1, u2):
    """The reference computes phi = acos(1-2u) then sin/cos(phi); since
    cos(acos(z)) = z and sin(acos(z)) = sqrt(1-z^2), the acos cancels
    out."""
    theta = jnp.float32(TWO_PI) * u1
    z = jnp.clip(1.0 - 2.0 * u2, -1.0, 1.0)
    sp = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    return (sp * jnp.cos(theta), sp * jnp.sin(theta), z)


# ----- Oren-Nayar (ref: mega_kernel.wgsl:182-209) -----

def oren_nayar_c(wo, wi, n, albedo, sigma):
    """albedo is a vec3 tuple; returns a vec3 tuple (f * albedo / pi)."""
    ndotv = jnp.maximum(vdot(n, wo), 0.0)
    ndotl = jnp.maximum(vdot(n, wi), 0.0)

    sig2 = sigma * sigma
    A = 1.0 - 0.5 * sig2 / (sig2 + 0.33)
    B = 0.45 * sig2 / (sig2 + 0.09)

    sin_v = jnp.sqrt(jnp.maximum(0.0, 1.0 - ndotv * ndotv))
    sin_l = jnp.sqrt(jnp.maximum(0.0, 1.0 - ndotl * ndotl))

    wo_t = vsub(wo, vscale(n, ndotv))
    wi_t = vsub(wi, vscale(n, ndotl))
    denom = jnp.maximum(sin_v * sin_l, 1e-20)
    cos_phi_raw = jnp.clip(vdot(wo_t, wi_t) / denom, -1.0, 1.0)
    cos_phi_diff = jnp.where((sin_v > 1e-6) & (sin_l > 1e-6), cos_phi_raw, 1.0)

    sin_alpha = jnp.maximum(sin_v, sin_l)
    tan_beta = jnp.minimum(sin_v, sin_l) / jnp.maximum(jnp.maximum(ndotv, ndotl), 1e-20)

    scale = jnp.float32(INV_PI) * (
        A + B * jnp.maximum(0.0, cos_phi_diff) * sin_alpha * tan_beta
    )
    valid = (ndotv >= 1e-6) & (ndotl >= 1e-6)
    scale = jnp.where(valid, scale, 0.0)
    return vscale(albedo, scale)


# ----- GGX / Trowbridge-Reitz (ref: mega_kernel.wgsl:213-256) -----

def tan2_theta_z(wz):
    c2 = wz * wz
    t2 = (1.0 - c2) / jnp.maximum(c2, 1e-10)
    return jnp.where(c2 < 1e-10, jnp.float32(1e20), t2)


def tr_d_c(wmz, alpha):
    tan2 = tan2_theta_z(wmz)
    cos4 = (wmz * wmz) * (wmz * wmz)
    a2 = alpha * alpha
    e = tan2 / jnp.maximum(a2, 1e-20)
    d = 1.0 / jnp.maximum(jnp.float32(PI) * a2 * cos4 * (1.0 + e) * (1.0 + e), 1e-30)
    return jnp.where(tan2 > 1e20, 0.0, d)


def tr_lambda_c(wz, alpha):
    tan2 = tan2_theta_z(wz)
    a2 = alpha * alpha
    lam = (jnp.sqrt(1.0 + a2 * tan2) - 1.0) * 0.5
    return jnp.where(tan2 > 1e20, 0.0, lam)


def tr_g_c(woz, wiz, alpha):
    return 1.0 / (1.0 + tr_lambda_c(woz, alpha) + tr_lambda_c(wiz, alpha))


def tr_g1_c(wz, alpha):
    return 1.0 / (1.0 + tr_lambda_c(wz, alpha))


def tr_sample_wm_c(wo, u1, u2, alpha):
    """VNDF sample in the local frame; wo is a local vec3 tuple."""
    wh = vnormalize((alpha * wo[0], alpha * wo[1], wo[2]), eps=1e-30)
    wh = vwhere(wh[2] < 0.0, vneg(wh), wh)

    zero = jnp.zeros_like(wh[0])
    one = jnp.ones_like(wh[0])
    # cross(+Z, wh) = (-wh.y, wh.x, 0)
    t1_raw = vnormalize((-wh[1], wh[0], zero), eps=1e-30)
    t1 = vwhere(jnp.abs(wh[2]) > 0.99999, (one, zero, zero), t1_raw)
    t2 = vcross(wh, t1)

    r = jnp.sqrt(u2)
    phi = jnp.float32(TWO_PI) * u1
    px = r * jnp.cos(phi)
    py = r * jnp.sin(phi)
    h = jnp.sqrt(jnp.maximum(0.0, 1.0 - px * px))
    py = h + ((1.0 + wh[2]) * 0.5) * (py - h)

    pz = jnp.sqrt(jnp.maximum(0.0, 1.0 - px * px - py * py))
    nh = vadd(vadd(vscale(t1, px), vscale(t2, py)), vscale(wh, pz))

    wm = (alpha * nh[0], alpha * nh[1], jnp.maximum(nh[2], 1e-6))
    return vnormalize(wm, eps=1e-30)


# ----- reflect / refract (ref: mega_kernel.wgsl:637-651) -----

def reflect_c(wo, n):
    return vsub(vscale(n, 2.0 * vdot(wo, n)), wo)


def refract_c(wo, n, eta):
    ct = vdot(n, wo)
    inside = ct < 0.0
    e = jnp.where(inside, 1.0 / eta, eta)
    na = vwhere(inside, vneg(n), n)
    ct = jnp.abs(ct)
    sin2_tt = jnp.maximum(0.0, 1.0 - ct * ct) / (e * e)
    tir = sin2_tt >= 1.0
    ct_t = jnp.sqrt(jnp.maximum(1.0 - sin2_tt, 0.0))
    wi = vadd(vscale(wo, -1.0 / e), vscale(na, ct / e - ct_t))
    wi = vwhere(tir, (jnp.zeros_like(wi[0]),) * 3, wi)
    return wi, ~tir


# ----- CIE lookup as an unrolled select chain -----
#
# The (N,3) path uses a one-hot matmul (ops/spectra.py); inside a
# component-form kernel the 81-entry table lerp unrolls into compare+selects
# instead.  It runs ONCE per frame per lane (lambda is fixed for
# the whole path), so the ~160 fused select ops amortize over every bounce.

def cie_to_rgb_c(lambda_nm):
    """Piecewise-linear CIE->sRGB response (ref: mega_kernel.wgsl:444-458).
    Returns a vec3 tuple of lambda_nm's shape."""
    t = (lambda_nm - jnp.float32(VISIBLE_MIN)) / jnp.float32(CIE_STEP)
    i = t.astype(jnp.int32)
    f = t - i.astype(jnp.float32)
    ia = jnp.minimum(i, N_CIE - 1)
    ib = jnp.minimum(i + 1, N_CIE - 1)
    zero = jnp.zeros_like(lambda_nm)
    va = [zero, zero, zero]
    vb = [zero, zero, zero]
    tbl = CIE_RGB_TABLE  # numpy (81, 3): entries bake in as immediates
    for j in range(N_CIE):
        ma = ia == j
        mb = ib == j
        for c in range(3):
            e = jnp.float32(tbl[j, c])
            va[c] = jnp.where(ma, e, va[c])
            vb[c] = jnp.where(mb, e, vb[c])
    return (
        va[0] * (1.0 - f) + vb[0] * f,
        va[1] * (1.0 - f) + vb[1] * f,
        va[2] * (1.0 - f) + vb[2] * f,
    )


# ----- primitive intersection (component form) -----

def sphere_hit_c(o, d, center, radius):
    """Near-root hit distance of rays (planes) vs ONE sphere (scalars).
    Returns (t, valid) (ref: mega_kernel.wgsl:279-299)."""
    oc = vsub(o, vbroadcast(center, o[0]))
    a = vdot(d, d)
    half_b = vdot(oc, d)
    c = vdot(oc, oc) - radius * radius
    disc = half_b * half_b - a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t = (-half_b - sq) * (1.0 / a)
    valid = (disc > 0.0) & (t > 0.0) & (radius > 0.0)
    return t, valid


def sphere_shadow_factor_c(o, d, t_max, lam, center, radius, mtype, ior):
    """Spectral transmission factor of ONE sphere for a shadow segment
    (ref: mega_kernel.wgsl:511-538). Returns planes in [0, 1]."""
    cb = vbroadcast(center, o[0])
    oc = vsub(o, cb)
    a = vdot(d, d)
    half_b = vdot(oc, d)
    c = vdot(oc, oc) - radius * radius
    disc = half_b * half_b - a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv_a = 1.0 / a
    t0 = (-half_b - sq) * inv_a
    t1 = (-half_b + sq) * inv_a
    overlap = (disc > 0.0) & (t1 > 0.0) & (t0 < t_max) & (radius > 0.0)

    t_entry = jnp.maximum(t0, 0.0)
    t_exit = jnp.minimum(t1, t_max)
    segment = t_entry < t_exit

    eta = cauchy_ior(ior, lam)
    p1 = vadd(o, vscale(d, t_entry))
    n1 = vnormalize(vsub(p1, cb), eps=1e-30)
    R1 = fr_dielectric(-vdot(n1, d), eta)
    p2 = vadd(o, vscale(d, t_exit))
    n2 = vnormalize(vsub(p2, cb), eps=1e-30)
    R2 = fr_dielectric(-vdot(n2, d), eta)

    dielectric_f = jnp.where(segment, (1.0 - R1) * (1.0 - R2), 1.0)
    # ONLY dielectrics (mtype 1) transmit; diffuse and metal occlude fully
    # (ref: mega_kernel.wgsl:521)
    factor = jnp.where(mtype == 1, dielectric_f, jnp.zeros_like(dielectric_f))
    return jnp.where(overlap, factor, 1.0)


def triangle_hit_c(o, d, a, e1, e2):
    """Moller-Trumbore vs ONE triangle (scalar tuples a, e1, e2).
    Returns (t, valid) (ref: mega_kernel.wgsl:303-338)."""
    eps = jnp.float32(1.17549435e-38)
    e1b = vbroadcast(e1, o[0])
    e2b = vbroadcast(e2, o[0])
    h = vcross(d, e2b)
    det = vdot(e1b, h)
    inv_det = 1.0 / jnp.where(jnp.abs(det) < eps, 1.0, det)
    s = vsub(o, vbroadcast(a, o[0]))
    u = inv_det * vdot(s, h)
    q = vcross(s, e1b)
    v = inv_det * vdot(d, q)
    t = inv_det * vdot(e2b, q)
    valid = (
        (jnp.abs(det) >= eps)
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (t > eps)
    )
    return t, valid


# ----- light sampling (component form) -----

def square_point_c(center, half_width, normal, u1, u2):
    """Uniform point on a square area light; center/normal are scalar vec3
    tuples (or plane tuples), u1/u2 planes (ref: mega_kernel.wgsl:688-696)."""
    T = build_tangent_frame_c(normal)
    B = vcross(normal, T)
    su = (u1 - 0.5) * 2.0 * half_width
    sv = (u2 - 0.5) * 2.0 * half_width
    return vadd(center, vadd(vscale(T, su), vscale(B, sv)))


def cosine_hemisphere_c(normal, u1, u2):
    """Cosine-weighted direction about `normal` (ref: mega_kernel.wgsl:698-708)."""
    theta = jnp.float32(TWO_PI) * u1
    r = jnp.sqrt(u2)
    x = r * jnp.cos(theta)
    y = r * jnp.sin(theta)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - r * r))
    T = build_tangent_frame_c(normal)
    B = vcross(normal, T)
    return vadd(vadd(vscale(T, x), vscale(B, y)), vscale(normal, z))


def cone_toward_c(axis, uc, u1, cos_half):
    """Direction in a cone about `axis` (scalar vec3 tuple), with the
    reference's draw semantics (ref: mega_kernel.wgsl:710-721)."""
    T = build_tangent_frame_c(axis)
    B = vcross(axis, T)
    ct = 1.0 - uc * (1.0 - cos_half)
    st = jnp.sqrt(jnp.maximum(0.0, 1.0 - ct * ct))
    phi = jnp.float32(TWO_PI) * u1
    return vadd(
        vadd(vscale(T, st * jnp.cos(phi)), vscale(B, st * jnp.sin(phi))),
        vscale(axis, ct),
    )


def hero_em_lookup_c(tab, delta, lam):
    """Folded periodic lookup into a hero_emission_table (see
    tpurt.ops.spectra.hero_emission_table): the C-averaged emission is
    periodic in lambda with period `delta` = range/C, so one small lerp
    chain replaces C full CIE chains. `tab` is a host numpy (n_seg+1, 3)
    whose entries bake in as immediates (like cie_to_rgb_c); lam is any
    plane shape; returns a vec3 tuple."""
    n_seg = tab.shape[0] - 1
    t = (lam - jnp.float32(VISIBLE_MIN)) / jnp.float32(delta)
    frac = t - jnp.floor(t)                     # periodic fold to [0, 1)
    u = frac * jnp.float32(n_seg)
    i = jnp.clip(u.astype(jnp.int32), 0, n_seg - 1)
    f = u - i.astype(jnp.float32)
    zero = jnp.zeros_like(lam)
    va = [zero, zero, zero]
    vb = [zero, zero, zero]
    for j in range(n_seg + 1):
        ma = i == j
        mb = (i + 1) == j
        for c in range(3):
            e = jnp.float32(tab[j, c])
            va[c] = jnp.where(ma, e, va[c])
            vb[c] = jnp.where(mb, e, vb[c])
    return (
        va[0] * (1.0 - f) + vb[0] * f,
        va[1] * (1.0 - f) + vb[1] * f,
        va[2] * (1.0 - f) + vb[2] * f,
    )


# ----- aimed photon emission (cfg.photon_aim EXTENSION; no reference
# counterpart — the reference's area lights always emit cosine-hemisphere,
# mega_kernel.wgsl:757-764) -----

# Cone half-angle clamps: never tighter than ~1.1 deg (bounds the aimed pdf
# at ~1/(2*pi*2e-4) so f32 mixture weights stay sane) and never wider than
# 45 deg (a wider "aim" is just a worse cosine sample).
AIM_SIN_MIN = 0.02
AIM_SIN_MAX = 0.7071


def aimed_cone_c(o, aim, radius, widen, ua, ub):
    """Uniform direction in the cone from `o` toward `aim` whose half-angle
    subtends `widen * radius` (the photon splat disc, padded) at the aim
    distance. All component-form planes; radius may be a scalar or a
    per-lane plane. Returns (dir, axis, cos_a) for aim_mixture_weight_c.

    Used by cfg.photon_aim: each photon emitted from an area light aims at
    the lane's own SPPM vispoint with probability q. The vispoint and the
    SPPM radius are fixed data of the photon integral being estimated (they
    come from the camera path / the schedule, never from the photon's own
    draws), so any emission pdf built from them is a valid importance
    sampler for the reference's cosine-emission target."""
    dv = vsub(aim, o)
    dist = jnp.sqrt(jnp.maximum(vdot(dv, dv), 1e-12))
    axis = vscale(dv, 1.0 / dist)
    sin_a = jnp.clip(widen * radius / dist,
                     jnp.float32(AIM_SIN_MIN), jnp.float32(AIM_SIN_MAX))
    cos_a = jnp.sqrt(1.0 - sin_a * sin_a)
    return cone_toward_c(axis, ua, ub, cos_a), axis, cos_a


def aim_mixture_weight_c(d, lnorm, axis, cos_a, q):
    """p_cos / p_mix for the defensive emission mixture whose target is the
    reference's cosine hemisphere about the light normal `lnorm`:

        p_mix(d) = q * U(aim cone)(d) + (1 - q) * cos(theta_n)/pi

    `q` is a per-lane plane in [0, 1) — 0 where the lane cannot aim (no
    vispoint yet), in which case the weight is exactly 1 and the estimator
    is bit-for-bit the reference's. q < 1 keeps the cosine component
    defending the whole hemisphere, so the weighted estimator is unbiased
    for EVERY downstream integrand (samples outside the aim cone get weight
    up to 1/(1-q); samples inside get p_cos/p_mix < 1)."""
    cos_n = jnp.maximum(vdot(d, lnorm), 0.0)
    p_cos = cos_n * jnp.float32(INV_PI)
    # Tolerance on the cone test (ADVICE r2): an aimed draw's f32-assembled
    # direction can land marginally below cos_a after rounding, which would
    # flip its assumed density to the out-of-cone branch (weight 1/(1-q)
    # instead of ~p_cos/(q*p_aim), p_aim up to ~796 at the 1.1deg clamp) —
    # rare boundary fireflies. 1e-6 is far above f32 rounding of a unit dot
    # and far below any real cone geometry.
    in_cone = vdot(d, axis) >= cos_a - jnp.float32(1e-6)
    p_aim = jnp.where(
        in_cone,
        1.0 / (jnp.float32(TWO_PI) * jnp.maximum(1.0 - cos_a, 1e-7)),
        jnp.float32(0.0))
    denom = q * p_aim + (1.0 - q) * p_cos
    return jnp.where(denom > 0.0, p_cos / jnp.maximum(denom, 1e-30),
                     jnp.float32(0.0))
