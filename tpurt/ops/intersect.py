"""Batched ray-scene intersection: spheres, triangles (Moller-Trumbore),
slab AABB tests, BVH traversal, and spectral shadow attenuation.

Reference semantics (ref: src/kernels/mega_kernel.wgsl):
  hit_sphere        :279-299   near root only, hit point pulled back x0.9999
  hit_triangle      :303-338   MT with subnormal epsilon 2^-126, offset along
                               the geometric normal by 1e-5
  closest_*_hit     :342-354, 395-428
  ray_aabb/BVH      :358-428   slab test, 64-deep traversal stack
  shadow_attenuation:511-564   dielectric spheres transmit (1-R1)(1-R2),
                               diffuse spheres / all triangles occlude fully

Array-first design: instead of a per-ray scalar loop we intersect a *tile* of
rays (N,) against primitive *chunks* (C,) as (N, C) vector ops, carrying the
running closest hit through a fori_loop.  This keeps peak memory at N*C
floats while staying fully data-parallel; per-chunk winner extraction uses
one-hot matmuls instead of gathers.  The BVH path (cfg.use_bvh) covers
closest-hit triangles of large meshes; the fused kernel sweeps its (small)
scenes brute force.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpurt.ops.bsdf import normalize
from tpurt.ops.spectra import cauchy_ior

F32_MIN_NORMAL = 1.17549435e-38  # bitcast<f32>(0x1p-126f) in the reference
BIG = 3.402823e38
MISS = jnp.float32(1e30)  # sentinel "no hit" distance (reference uses -1e7)


def _onehot_select(idx, chunk):
    """Select rows of `chunk` (C, D) by per-lane idx (N,) via one-hot matmul.

    Gather-free: one (N, C) @ (C, D) product. Used to extract the winning
    primitive's attributes after a chunk argmin.
    """
    C = chunk.shape[0]
    oh = (idx[..., None] == jnp.arange(C, dtype=jnp.int32)).astype(chunk.dtype)
    # HIGHEST: a float32 matmul may otherwise run in TF32 (GPU) — the
    # selected centers/normals/ids would silently lose ~13 mantissa bits
    return jnp.matmul(oh, chunk, precision=jax.lax.Precision.HIGHEST)


def _chunk_iter(n, chunk):
    chunk = min(chunk, n) if n > 0 else 1
    nchunks = -(-n // chunk) if n > 0 else 0
    return chunk, nchunks


# ----- Spheres -----

def sphere_candidates(ray_o, ray_d, centers, radii):
    """Near-root distances of rays (N,3) vs spheres (C,3)/(C,).

    Returns (t, valid) with shapes (N, C). Padded spheres (radius == 0) never
    report a hit. Matches ref: mega_kernel.wgsl:279-299 (near root only,
    discriminant > 0 strictly).
    """
    oc = ray_o[:, None, :] - centers[None, :, :]          # (N, C, 3)
    a = jnp.sum(ray_d * ray_d, axis=-1)[:, None]          # (N, 1)
    half_b = jnp.sum(oc * ray_d[:, None, :], axis=-1)     # (N, C)
    c = jnp.sum(oc * oc, axis=-1) - (radii * radii)[None, :]
    disc = half_b * half_b - a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv_a = 1.0 / a  # one reciprocal per ray, multiplies per sphere
    t = (-half_b - sq) * inv_a
    valid = (disc > 0.0) & (t > 0.0) & (radii[None, :] > 0.0)
    return t, valid


def closest_sphere_hit(ray_o, ray_d, centers, radii, mat_ids, chunk=512):
    """Closest positive sphere hit for each ray in the tile.

    Returns dict(t, loc, normal, mat) with t == MISS where no sphere is hit.
    Hit point is pulled back by x0.9999 along the ray and the normal is the
    outward geometric normal, as in the reference.
    """
    S = centers.shape[0]
    N = ray_o.shape[0]
    csize, nchunks = _chunk_iter(S, chunk)

    # Pad primitive arrays to a whole number of chunks with inert spheres.
    pad = csize * max(nchunks, 1) - S
    centers_p = jnp.pad(centers, ((0, pad), (0, 0)))
    radii_p = jnp.pad(radii, (0, pad))
    mats_p = jnp.pad(mat_ids.astype(jnp.float32), (0, pad))

    def body(i, carry):
        best_t, best_center, best_mat = carry
        sl = i * csize
        c_cen = jax.lax.dynamic_slice_in_dim(centers_p, sl, csize, axis=0)
        c_rad = jax.lax.dynamic_slice_in_dim(radii_p, sl, csize, axis=0)
        c_mat = jax.lax.dynamic_slice_in_dim(mats_p, sl, csize, axis=0)
        t, valid = sphere_candidates(ray_o, ray_d, c_cen, c_rad)
        t = jnp.where(valid, t, MISS)
        tmin = jnp.min(t, axis=-1)
        idx = jnp.argmin(t, axis=-1).astype(jnp.int32)
        sel = _onehot_select(idx, jnp.concatenate([c_cen, c_mat[:, None]], axis=-1))
        better = tmin < best_t
        best_t = jnp.where(better, tmin, best_t)
        best_center = jnp.where(better[:, None], sel[:, :3], best_center)
        best_mat = jnp.where(better, sel[:, 3], best_mat)
        return best_t, best_center, best_mat

    init = (jnp.full((N,), MISS), jnp.zeros((N, 3)), jnp.zeros((N,)))
    best_t, best_center, best_mat = jax.lax.fori_loop(0, max(nchunks, 0), body, init)

    loc = ray_o + ray_d * (best_t * 0.9999)[:, None]
    nrm = normalize(loc - best_center, eps=1e-30)
    return {
        "t": best_t,
        "loc": loc,
        "normal": nrm,
        "mat": jnp.round(best_mat).astype(jnp.int32),
    }


# ----- Triangles (Moller-Trumbore) -----

def triangle_candidates(ray_o, ray_d, tri_a, tri_e1, tri_e2):
    """MT intersection distances of rays (N,3) vs triangles (C,3)x3.

    Returns (t, valid), shapes (N, C). Degenerate (zero-edge padding)
    triangles yield det ~ 0 and are rejected by the subnormal epsilon,
    matching ref: mega_kernel.wgsl:303-338.
    """
    eps = jnp.float32(F32_MIN_NORMAL)
    h = jnp.cross(ray_d[:, None, :], tri_e2[None, :, :])   # (N, C, 3)
    det = jnp.sum(tri_e1[None, :, :] * h, axis=-1)
    inv_det = 1.0 / jnp.where(jnp.abs(det) < eps, 1.0, det)
    s = ray_o[:, None, :] - tri_a[None, :, :]
    u = inv_det * jnp.sum(s * h, axis=-1)
    q = jnp.cross(s, tri_e1[None, :, :])
    v = inv_det * jnp.sum(ray_d[:, None, :] * q, axis=-1)
    t = inv_det * jnp.sum(tri_e2[None, :, :] * q, axis=-1)
    valid = (
        (jnp.abs(det) >= eps)
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (t > eps)
    )
    return t, valid


def closest_triangle_hit(ray_o, ray_d, tri_a, tri_e1, tri_e2, tri_n, tri_mat, chunk=256):
    """Closest triangle hit via a chunked brute-force sweep.

    tri_n is the precomputed unit geometric normal normalize(cross(e1, e2)).
    Hit location = origin + normal*1e-5 + dir*t (reference's offset scheme).
    """
    T = tri_a.shape[0]
    N = ray_o.shape[0]
    if T == 0:
        return {
            "t": jnp.full((N,), MISS),
            "loc": jnp.zeros((N, 3)),
            "normal": jnp.zeros((N, 3)),
            "mat": jnp.zeros((N,), jnp.int32),
        }
    csize, nchunks = _chunk_iter(T, chunk)
    pad = csize * nchunks - T
    a_p = jnp.pad(tri_a, ((0, pad), (0, 0)))
    e1_p = jnp.pad(tri_e1, ((0, pad), (0, 0)))
    e2_p = jnp.pad(tri_e2, ((0, pad), (0, 0)))
    n_p = jnp.pad(tri_n, ((0, pad), (0, 0)))
    m_p = jnp.pad(tri_mat.astype(jnp.float32), (0, pad))

    def body(i, carry):
        best_t, best_n, best_mat = carry
        sl = i * csize
        c_a = jax.lax.dynamic_slice_in_dim(a_p, sl, csize, axis=0)
        c_e1 = jax.lax.dynamic_slice_in_dim(e1_p, sl, csize, axis=0)
        c_e2 = jax.lax.dynamic_slice_in_dim(e2_p, sl, csize, axis=0)
        c_n = jax.lax.dynamic_slice_in_dim(n_p, sl, csize, axis=0)
        c_m = jax.lax.dynamic_slice_in_dim(m_p, sl, csize, axis=0)
        t, valid = triangle_candidates(ray_o, ray_d, c_a, c_e1, c_e2)
        t = jnp.where(valid, t, MISS)
        tmin = jnp.min(t, axis=-1)
        idx = jnp.argmin(t, axis=-1).astype(jnp.int32)
        sel = _onehot_select(idx, jnp.concatenate([c_n, c_m[:, None]], axis=-1))
        better = tmin < best_t
        best_t = jnp.where(better, tmin, best_t)
        best_n = jnp.where(better[:, None], sel[:, :3], best_n)
        best_mat = jnp.where(better, sel[:, 3], best_mat)
        return best_t, best_n, best_mat

    init = (jnp.full((N,), MISS), jnp.zeros((N, 3)), jnp.zeros((N,)))
    best_t, best_n, best_mat = jax.lax.fori_loop(0, nchunks, body, init)

    loc = ray_o + best_n * 1e-5 + ray_d * best_t[:, None]
    return {
        "t": best_t,
        "loc": loc,
        "normal": best_n,
        "mat": jnp.round(best_mat).astype(jnp.int32),
    }


def combine_hits(h1, h2):
    """Nearest-of-two hit combine (ref: mega_kernel.wgsl:874-878)."""
    take2 = h2["t"] < h1["t"]
    return {
        "t": jnp.where(take2, h2["t"], h1["t"]),
        "loc": jnp.where(take2[:, None], h2["loc"], h1["loc"]),
        "normal": jnp.where(take2[:, None], h2["normal"], h1["normal"]),
        "mat": jnp.where(take2, h2["mat"], h1["mat"]),
    }


# ----- AABB slab test -----

def ray_aabb(ray_o, ray_d, bmin, bmax):
    """Slab test with the reference's parallel-axis handling
    (ref: mega_kernel.wgsl:358-393). Broadcasts rays (...,3) vs boxes (...,3).
    tmin starts at 0, so hits behind the origin don't count."""
    parallel = jnp.abs(ray_d) < 1e-20
    inv = 1.0 / jnp.where(parallel, 1.0, ray_d)
    t0 = (bmin - ray_o) * inv
    t1 = (bmax - ray_o) * inv
    tlo = jnp.minimum(t0, t1)
    thi = jnp.maximum(t0, t1)
    tlo = jnp.where(parallel, 0.0, tlo)
    thi = jnp.where(parallel, BIG, thi)
    inside_par = (ray_o >= bmin) & (ray_o <= bmax)
    ok_par = jnp.all(jnp.where(parallel, inside_par, True), axis=-1)
    tmin = jnp.maximum(jnp.max(tlo, axis=-1), 0.0)
    tmax = jnp.min(thi, axis=-1)
    return (tmax >= tmin) & ok_par


def ray_aabb_entry(ray_o, ray_d, bmin, bmax):
    """ray_aabb plus the entry distance, for best-hit subtree pruning."""
    parallel = jnp.abs(ray_d) < 1e-20
    inv = 1.0 / jnp.where(parallel, 1.0, ray_d)
    t0 = (bmin - ray_o) * inv
    t1 = (bmax - ray_o) * inv
    tlo = jnp.minimum(t0, t1)
    thi = jnp.maximum(t0, t1)
    tlo = jnp.where(parallel, 0.0, tlo)
    thi = jnp.where(parallel, BIG, thi)
    inside_par = (ray_o >= bmin) & (ray_o <= bmax)
    ok_par = jnp.all(jnp.where(parallel, inside_par, True), axis=-1)
    tmin = jnp.maximum(jnp.max(tlo, axis=-1), 0.0)
    tmax = jnp.min(thi, axis=-1)
    return (tmax >= tmin) & ok_par, tmin


# ----- BVH traversal (XLA path; per-ray stack, vmapped over the tile) -----

STACK_DEPTH = 64


def _bvh_hit_single(ray_o, ray_d, bvh, max_leaf):
    """Closest triangle hit via BVH for ONE ray; vmapped by bvh_hit.

    bvh: dict with node arrays (bbox_min, bbox_max, left, right, first, count)
    and flat tri arrays (tri_a, tri_e1, tri_e2, tri_n, tri_mat) already
    permuted into leaf order so leaves index a contiguous [first, first+count)
    range — this removes the tri_indices indirection of the reference layout.
    """
    def cond(state):
        sp = state[1]
        return sp > 0

    def body(state):
        stack, sp, best_t, best_n, best_mat = state
        sp = sp - 1
        node = stack[sp]
        bmin = bvh["bbox_min"][node]
        bmax = bvh["bbox_max"][node]
        # prune subtrees whose box entry lies beyond the current best hit
        in_box, t_entry = ray_aabb_entry(ray_o, ray_d, bmin, bmax)
        hit_box = in_box & (t_entry < best_t)
        count = bvh["count"][node]
        is_leaf = count > 0
        first = bvh["first"][node]

        def leaf_case(args):
            stack, sp, best_t, best_n, best_mat = args
            def tri_body(i, carry):
                bt, bn, bm = carry
                live = i < count
                ti = first + i
                a = bvh["tri_a"][ti]
                e1 = bvh["tri_e1"][ti]
                e2 = bvh["tri_e2"][ti]
                t, valid = triangle_candidates(
                    ray_o[None], ray_d[None], a[None], e1[None], e2[None]
                )
                t = jnp.where(valid & live, t, MISS)[0, 0]
                better = t < bt
                bt = jnp.where(better, t, bt)
                bn = jnp.where(better, bvh["tri_n"][ti], bn)
                bm = jnp.where(better, bvh["tri_mat"][ti], bm)
                return bt, bn, bm
            best_t, best_n, best_mat = jax.lax.fori_loop(
                0, max_leaf, tri_body, (best_t, best_n, best_mat)
            )
            return stack, sp, best_t, best_n, best_mat

        def inner_case(args):
            stack, sp, best_t, best_n, best_mat = args
            stack = stack.at[sp].set(bvh["right"][node])
            stack = stack.at[sp + 1].set(bvh["left"][node])
            return stack, sp + 2, best_t, best_n, best_mat

        def skip_case(args):
            return args

        return jax.lax.cond(
            hit_box,
            lambda a: jax.lax.cond(is_leaf, leaf_case, inner_case, a),
            skip_case,
            (stack, sp, best_t, best_n, best_mat),
        )

    stack0 = jnp.zeros((STACK_DEPTH,), jnp.int32)
    init = (stack0, jnp.int32(1), MISS, jnp.zeros((3,)), jnp.int32(0))
    _, _, best_t, best_n, best_mat = jax.lax.while_loop(cond, body, init)
    loc = ray_o + best_n * 1e-5 + ray_d * best_t
    return best_t, loc, best_n, best_mat


def bvh_hit(ray_o, ray_d, bvh, max_leaf=4):
    """Closest triangle hit for a tile of rays using the BVH (jnp/XLA path)."""
    f = functools.partial(_bvh_hit_single, bvh=bvh, max_leaf=max_leaf)
    t, loc, nrm, mat = jax.vmap(f)(ray_o, ray_d)
    return {"t": t, "loc": loc, "normal": nrm, "mat": mat}


# ----- Shadow attenuation -----

def sphere_shadow_factors(ray_o, ray_d, t_max, centers, radii, mtype, ior, lambda_nm):
    """Per-sphere spectral transmission factors for a shadow segment.

    Reference semantics (ref: mega_kernel.wgsl:511-538): for each sphere whose
    [entry, exit] interval overlaps (0, t_max): diffuse -> factor 0;
    dielectric -> (1-R1)(1-R2) with Cauchy IOR at this lane's wavelength.
    Returns factors (N, C); the caller multiplies them together.
    """
    oc = ray_o[:, None, :] - centers[None, :, :]
    a = jnp.sum(ray_d * ray_d, axis=-1)[:, None]
    half_b = jnp.sum(oc * ray_d[:, None, :], axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - (radii * radii)[None, :]
    disc = half_b * half_b - a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv_a = 1.0 / a
    t0 = (-half_b - sq) * inv_a
    t1 = (-half_b + sq) * inv_a
    overlap = (disc > 0.0) & (t1 > 0.0) & (t0 < t_max[:, None]) & (radii[None, :] > 0.0)

    t_entry = jnp.maximum(t0, 0.0)
    t_exit = jnp.minimum(t1, t_max[:, None])
    segment = t_entry < t_exit

    eta = cauchy_ior(ior[None, :], lambda_nm[:, None])
    p1 = ray_o[:, None, :] + ray_d[:, None, :] * t_entry[..., None]
    n1 = normalize(p1 - centers[None, :, :], eps=1e-30)
    cos1 = -jnp.sum(n1 * ray_d[:, None, :], axis=-1)
    from tpurt.ops.bsdf import fr_dielectric
    R1 = fr_dielectric(cos1, eta)
    p2 = ray_o[:, None, :] + ray_d[:, None, :] * t_exit[..., None]
    n2 = normalize(p2 - centers[None, :, :], eps=1e-30)
    cos2 = -jnp.sum(n2 * ray_d[:, None, :], axis=-1)
    R2 = fr_dielectric(cos2, eta)

    dielectric_f = jnp.where(segment, (1.0 - R1) * (1.0 - R2), 1.0)
    # only dielectrics transmit; diffuse AND metal occlude fully
    factor = jnp.where(mtype[None, :] == 1, dielectric_f, 0.0)
    return jnp.where(overlap, factor, 1.0)


def shadow_attenuation(
    ray_o, ray_d, t_max, lambda_nm,
    centers, radii, sph_mtype, sph_ior,
    tri_a, tri_e1, tri_e2,
    chunk=512, tri_chunk=256,
):
    """Spectral shadow attenuation along (0, t_max) for a tile of rays.

    Product over spheres of their transmission factor, times a binary
    triangle occlusion term (any triangle hit -> 0). Brute-force chunked
    sweep; matches the reference's BVH shadow walk results exactly.
    """
    N = ray_o.shape[0]
    atten = jnp.ones((N,))

    S = centers.shape[0]
    if S > 0:
        csize, nchunks = _chunk_iter(S, chunk)
        pad = csize * nchunks - S
        cen_p = jnp.pad(centers, ((0, pad), (0, 0)))
        # inert padding: radius 0 never overlaps
        rad_p = jnp.pad(radii, (0, pad))
        mt_p = jnp.pad(sph_mtype, (0, pad), constant_values=1)
        io_p = jnp.pad(sph_ior, (0, pad), constant_values=1.0)

        def sbody(i, acc):
            sl = i * csize
            f = sphere_shadow_factors(
                ray_o, ray_d, t_max,
                jax.lax.dynamic_slice_in_dim(cen_p, sl, csize, axis=0),
                jax.lax.dynamic_slice_in_dim(rad_p, sl, csize, axis=0),
                jax.lax.dynamic_slice_in_dim(mt_p, sl, csize, axis=0),
                jax.lax.dynamic_slice_in_dim(io_p, sl, csize, axis=0),
                lambda_nm,
            )
            return acc * jnp.prod(f, axis=-1)

        atten = jax.lax.fori_loop(0, nchunks, sbody, atten)

    T = tri_a.shape[0]
    if T > 0:
        csize, nchunks = _chunk_iter(T, tri_chunk)
        pad = csize * nchunks - T
        a_p = jnp.pad(tri_a, ((0, pad), (0, 0)))
        e1_p = jnp.pad(tri_e1, ((0, pad), (0, 0)))
        e2_p = jnp.pad(tri_e2, ((0, pad), (0, 0)))

        def tbody(i, occluded):
            sl = i * csize
            t, valid = triangle_candidates(
                ray_o, ray_d,
                jax.lax.dynamic_slice_in_dim(a_p, sl, csize, axis=0),
                jax.lax.dynamic_slice_in_dim(e1_p, sl, csize, axis=0),
                jax.lax.dynamic_slice_in_dim(e2_p, sl, csize, axis=0),
            )
            hit_any = jnp.any(valid & (t < t_max[:, None]), axis=-1)
            return occluded | hit_any

        occluded = jax.lax.fori_loop(0, nchunks, tbody, jnp.zeros((N,), bool))
        atten = jnp.where(occluded, 0.0, atten)

    return atten
