"""Fused-kernel scaffolding: the frozen scene, the component-form
integrator pieces and the plane layout of the regenerative megakernel
(tpurt.kernels.mega_regen).

The hot loop of the renderer (ref: src/kernels/mega_kernel.wgsl: cs_main
:984-1021, recursive_trace :865-982, trace_photon :745-861) runs as one
``pallas_call`` over pixel tiles:

  * each program owns `pallas_lanes` pixels laid out as (R, 128) float32
    planes (R = lanes / 128): one lane per pixel, the reference's own
    one-invocation-per-pixel model (see tpurt.ops.soa);
  * the whole bounce loop runs with path state in registers; HBM traffic
    is the 16 accumulation/vispoint planes of the tile;
  * **the scene is a compile-time constant** (``freeze_scene``): sphere
    centers, materials and lights bake into the instruction stream, like
    the reference hard-codes its scene at startup (ref: lib.rs:220-447),
    so diffuse occluders skip the Fresnel transmission chain, padding
    primitives vanish, and point-vs-area light branches resolve at trace
    time.  Above ``cfg.pallas_static_unroll`` primitives the sweep reads a
    primitive table in device memory instead.

RNG draw order matches tpurt.integrate *exactly*, so the kernel and the XLA
integrator produce the same image for the same seed (up to float
reassociation); tests/test_mega_pallas.py asserts this.

Scope: sphere + small-mesh scenes (``supports_scene``). Larger scenes run
through the XLA integrator (``backend="xla"``, optionally ``use_bvh``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tpurt.config import RenderConfig
from tpurt.ops import rng as rngmod
from tpurt.ops import soa as s
from tpurt.ops.bsdf import fr_dielectric
from tpurt.ops.scatter_c import (
    EPS,
    diffuse_scatter_c,
    scatter_dielectric_c,
    scatter_metal_c,
)
from tpurt.ops.spectra import DISPERSION_B, VISIBLE_RANGE, blackbody

MISS = np.float32(1e30)  # numpy scalar: kernels can't capture device arrays
_HIT = np.float32(MISS * 0.5)
PHOTON_CONE_COS = 0.707  # ref: mega_kernel.wgsl:103

N_CHANNELS = 16  # rgb_sum 3 | vis_pos 3 | vis_norm 3 | vis_wo 3 | vis_tp 3 | vis_mat 1
# channel index bases for the persistent planes
_VPOS, _VNORM, _VWO, _VTP, _VMAT = 3, 6, 9, 12, 15

# Scenes up to cfg.pallas_static_unroll primitives are unrolled into the
# instruction stream (constant folding: diffuse occluders lose their Fresnel
# chains, padding vanishes). Above it, primitives live in a device-memory
# table swept by a fori_loop — same physics, runtime material branches, a
# compile time independent of the count. The sweep is brute force, so the
# kernel takes tables only up to these counts; larger scenes belong to the
# XLA integrator's BVH (cfg.use_bvh).
MAX_DYNAMIC_SPHERES = 512  # sphere table rows (S x 8 f32)
MAX_DYNAMIC_TRIS = 256     # triangle table rows (T x 16 f32)


def _mask_i32(m):
    # bool mask -> i32 plane (loop carries and reductions stay integer)
    return jnp.where(m, jnp.int32(1), jnp.int32(0))


def _mask_f32(m):
    return jnp.where(m, jnp.float32(1.0), jnp.float32(0.0))


def _any(m):
    """Whole-tile vote: does any lane of the plane `m` hold? A max over an
    i32 plane (the Triton lowering has no boolean or-reduction)."""
    return jnp.max(_mask_i32(m)) > 0


# ----- frozen (compile-time) scene -----

@dataclasses.dataclass(frozen=True)
class _FSphere:
    c: tuple        # (cx, cy, cz)
    r: float
    mat: int
    mtype: int      # resolved material type (shadow pass)
    ior: float      # resolved base IOR (shadow pass)


@dataclasses.dataclass(frozen=True)
class _FMaterial:
    color: tuple    # (r, g, b)
    rough: float
    ior: float
    mtype: int


@dataclasses.dataclass(frozen=True)
class _FLight:
    pos: tuple
    hw: float
    color: tuple
    intensity: float
    temp: float
    ltype: int
    normal: tuple   # unit, y <= 0 (ref: light.rs:39-40)
    tangent: tuple  # frame of `normal` (square sampling / cosine emission)
    bitangent: tuple
    cone_axis: tuple      # normalize(origin - pos) (photon emission)
    cone_t: tuple         # frame of cone_axis
    cone_b: tuple


@dataclasses.dataclass(frozen=True)
class _FTriangle:
    a: tuple
    e1: tuple
    e2: tuple
    n: tuple        # unit geometric normal (leaf order, see tpurt.scene)
    mat: int


@dataclasses.dataclass(frozen=True)
class FrozenScene:
    spheres: tuple
    materials: tuple
    lights: tuple
    triangles: tuple = ()


def _np_tangent_frame(n):
    """Host mirror of soa.build_tangent_frame_c (ref: mega_kernel.wgsl:677-681)."""
    n = np.asarray(n, np.float32)
    if abs(float(n[1])) > 0.99999:
        t = np.array([1.0, 0.0, 0.0], np.float32)
    else:
        t = np.array([n[2], 0.0, -n[0]], np.float32)
        t = t / np.sqrt(max(float(t @ t), 1e-30))
    b = np.cross(n, t)
    return tuple(float(x) for x in t), tuple(float(x) for x in b)


def freeze_scene(scene) -> FrozenScene:
    """Concrete Scene pytree -> hashable compile-time constants.

    Must be called OUTSIDE jit (needs concrete values). The reference bakes
    its scene into host code at startup (lib.rs:220-447); we bake it into the
    kernel at compile time — a scene change costs one recompile, exactly like
    the reference costs a rebuild.
    """
    cen = np.asarray(scene.sph_center, np.float32)
    rad = np.asarray(scene.sph_radius, np.float32)
    smat = np.asarray(scene.sph_mat, np.int32)
    smtype = np.asarray(scene.sph_mtype, np.int32)
    sior = np.asarray(scene.sph_ior, np.float32)
    spheres = tuple(
        _FSphere(c=tuple(float(x) for x in cen[i]), r=float(rad[i]),
                 mat=int(smat[i]), mtype=int(smtype[i]), ior=float(sior[i]))
        for i in range(cen.shape[0]) if float(rad[i]) > 0.0
    )
    mc = np.asarray(scene.mat_color, np.float32)
    mr = np.asarray(scene.mat_rough, np.float32)
    mi = np.asarray(scene.mat_ior, np.float32)
    mt = np.asarray(scene.mat_type, np.int32)
    materials = tuple(
        _FMaterial(color=tuple(float(x) for x in mc[i]), rough=float(mr[i]),
                   ior=float(mi[i]), mtype=int(mt[i]))
        for i in range(mc.shape[0])
    )
    lp = np.asarray(scene.light_pos, np.float32)
    lhw = np.asarray(scene.light_hw, np.float32)
    lc = np.asarray(scene.light_color, np.float32)
    li = np.asarray(scene.light_intensity, np.float32)
    lt = np.asarray(scene.light_temp, np.float32)
    lty = np.asarray(scene.light_type, np.int32)
    ln = np.asarray(scene.light_normal, np.float32)
    lights = []
    for j in range(lp.shape[0]):
        normal = tuple(float(x) for x in ln[j])
        tangent, bitangent = _np_tangent_frame(normal)
        pos = tuple(float(x) for x in lp[j])
        axis = -np.asarray(pos, np.float32)
        axis = axis / np.sqrt(max(float(axis @ axis), 1e-30))
        cone_t, cone_b = _np_tangent_frame(axis)
        lights.append(_FLight(
            pos=pos, hw=float(lhw[j]), color=tuple(float(x) for x in lc[j]),
            intensity=float(li[j]), temp=float(lt[j]), ltype=int(lty[j]),
            normal=normal, tangent=tangent, bitangent=bitangent,
            cone_axis=tuple(float(x) for x in axis),
            cone_t=cone_t, cone_b=cone_b,
        ))
    ta = np.asarray(scene.tri_a, np.float32)
    te1 = np.asarray(scene.tri_e1, np.float32)
    te2 = np.asarray(scene.tri_e2, np.float32)
    tn = np.asarray(scene.tri_n, np.float32)
    tm = np.asarray(scene.tri_mat, np.int32)
    tup = lambda v: tuple(float(x) for x in v)
    triangles = tuple(
        _FTriangle(a=tup(ta[i]), e1=tup(te1[i]), e2=tup(te2[i]),
                   n=tup(tn[i]), mat=int(tm[i]))
        for i in range(ta.shape[0])
    )
    return FrozenScene(spheres=spheres, materials=materials,
                       lights=tuple(lights), triangles=triangles)


def supports_scene(scene, cfg=None) -> bool:
    """The fused kernel covers sphere + small-mesh scenes: primitives unroll
    up to cfg.pallas_static_unroll (with the tile-coherent cull tree above
    4x pallas_cluster_size), and above it sweep a device-memory table of at
    most MAX_DYNAMIC_SPHERES / MAX_DYNAMIC_TRIS rows."""
    unroll = cfg.pallas_static_unroll if cfg is not None else 0
    return (scene.num_triangles <= max(MAX_DYNAMIC_TRIS, unroll)
            and scene.num_spheres <= max(MAX_DYNAMIC_SPHERES, unroll))


def check_scene(scene, cfg) -> None:
    """Raise unless the fused kernel takes this scene. backend="pallas"
    never reroutes a scene to another integrator behind the caller's back."""
    if not supports_scene(scene, cfg):
        raise ValueError(
            f"backend='pallas' takes at most "
            f"{max(MAX_DYNAMIC_SPHERES, cfg.pallas_static_unroll)} spheres "
            f"and {max(MAX_DYNAMIC_TRIS, cfg.pallas_static_unroll)} "
            f"triangles; this scene has {scene.num_spheres} spheres and "
            f"{scene.num_triangles} triangles — render it with "
            f"backend='xla' (use_bvh=True for meshes)")


# ----- component-form integrator pieces (mirror tpurt.integrate) -----

def _sweep_spheres_static(spheres, o, d, a, state):
    """Winner sweep over constant spheres, continuing from `state`
    (best_t, best_center, best_mat) — the unrolled inner loop shared by the
    flat and clustered intersectors (wgsl :342-354)."""
    best_t, best_c, best_mat = state
    inv_a = 1.0 / a  # one reciprocal per lane; multiplies per sphere
    for sp in spheres:
        oc = (o[0] - sp.c[0], o[1] - sp.c[1], o[2] - sp.c[2])
        half_b = s.vdot(oc, d)
        c = s.vdot(oc, oc) - sp.r * sp.r
        disc = half_b * half_b - a * c
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t = (-half_b - sq) * inv_a
        t = jnp.where((disc > 0.0) & (t > 0.0), t, MISS)
        better = t < best_t
        best_t = jnp.where(better, t, best_t)
        best_c = s.vwhere(better, s.vbroadcast(sp.c, o[0]), best_c)
        best_mat = jnp.where(better, np.int32(sp.mat), best_mat)
    return best_t, best_c, best_mat


def _sphere_state_init(o):
    return (jnp.full_like(o[0], MISS), (jnp.zeros_like(o[0]),) * 3,
            jnp.zeros_like(o[0], jnp.int32))


def _sphere_state_finish(o, d, state):
    best_t, best_c, best_mat = state
    loc = s.vadd(o, s.vscale(d, best_t * 0.9999))
    nrm = s.vnormalize(s.vsub(loc, best_c), eps=1e-30)
    return best_t, loc, nrm, best_mat


def _closest_sphere_static(spheres, o, d):
    """Unrolled winner loop over constant spheres (wgsl :342-354)."""
    a = s.vdot(d, d)
    state = _sweep_spheres_static(spheres, o, d, a, _sphere_state_init(o))
    return _sphere_state_finish(o, d, state)


def _shadow_sweep_static(spheres, o, d, t_max, lam, a, atten):
    """Shadow-factor sweep over constant spheres, continuing from `atten`
    (wgsl :511-538). Static material types let diffuse occluders skip the
    entire Fresnel chain: their factor is just `overlap ? 0 : 1`."""
    inv_a = 1.0 / a
    for sp in spheres:
        cb = s.vbroadcast(sp.c, o[0])
        oc = s.vsub(o, cb)
        half_b = s.vdot(oc, d)
        c = s.vdot(oc, oc) - sp.r * sp.r
        disc = half_b * half_b - a * c
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t0 = (-half_b - sq) * inv_a
        t1 = (-half_b + sq) * inv_a
        overlap = (disc > 0.0) & (t1 > 0.0) & (t0 < t_max)
        if sp.mtype != 1:  # diffuse and metal occlude fully
            atten = atten * jnp.where(overlap, 0.0, 1.0)
            continue
        t_entry = jnp.maximum(t0, 0.0)
        t_exit = jnp.minimum(t1, t_max)
        segment = t_entry < t_exit
        eta = sp.ior + jnp.float32(DISPERSION_B) / ((lam * 1e-3) * (lam * 1e-3))
        p1 = s.vadd(o, s.vscale(d, t_entry))
        n1 = s.vnormalize(s.vsub(p1, cb), eps=1e-30)
        R1 = fr_dielectric(-s.vdot(n1, d), eta)
        p2 = s.vadd(o, s.vscale(d, t_exit))
        n2 = s.vnormalize(s.vsub(p2, cb), eps=1e-30)
        R2 = fr_dielectric(-s.vdot(n2, d), eta)
        f = jnp.where(segment, (1.0 - R1) * (1.0 - R2), 1.0)
        atten = atten * jnp.where(overlap, f, 1.0)
    return atten


def _shadow_static(spheres, o, d, t_max, lam):
    a = s.vdot(d, d)
    return _shadow_sweep_static(spheres, o, d, t_max, lam, a,
                                jnp.ones_like(o[0]))


# ----- tile-coherent cull tree (whole-tile BVH traversal) -----
#
# The instanced-scene sweep (e.g. BASELINE config 3: 257 spheres) is the
# one place the megakernel is compute-bound on pure intersection math. A
# per-lane BVH walk is hostile to the (R,128) SIMD model (divergent stacks,
# per-lane gathers), but a TILE-level traversal works with it: primitives
# are median-split (same rule as accel.build_bvh, instance.rs:259-269) into
# a BVH whose every node is a lax.cond — the whole tile descends into a
# node only if SOME relevant lane's ray enters its AABB closer than that
# lane's current best hit (/ shadow t_max). Leaves are unrolled constant
# sweeps. Coherent tiles (camera rays, shadow rays toward one light,
# ground-local bounces) prune whole subtrees; fully incoherent tiles
# degrade to the flat sweep + ~2N/leaf box tests, never worse
# asymptotically. Block-shaped tiles (pallas_block_tiles) keep the votes
# coherent.

class _CullNode(NamedTuple):
    bmin: tuple
    bmax: tuple
    children: tuple   # of _CullNode; () for a leaf
    prims: tuple      # leaf primitives; () for internal nodes


class _CullTree(NamedTuple):
    always: tuple     # swept unconditionally (scene-spanning bounds)
    root: object      # _CullNode or None


def _build_cull_tree(prims, lo, hi, leaf_size: int, always_mask) -> _CullTree:
    """Host-side recursive median split on the longest centroid axis.
    lo/hi: (N, 3) primitive AABBs; always_mask: primitives whose bounds
    span the scene (culling them is useless — sweep flat)."""
    always = tuple(p for p, h in zip(prims, always_mask) if h)
    keep = np.flatnonzero(~np.asarray(always_mask))

    def build(idx):
        bmin = tuple(float(x) for x in lo[idx].min(axis=0))
        bmax = tuple(float(x) for x in hi[idx].max(axis=0))
        if len(idx) <= leaf_size:
            return _CullNode(bmin, bmax, (),
                             tuple(prims[i] for i in idx))
        cen = (lo[idx] + hi[idx]) * 0.5
        ax = int((cen.max(axis=0) - cen.min(axis=0)).argmax())
        order = idx[np.argsort(cen[:, ax], kind="stable")]
        h = len(order) // 2
        return _CullNode(bmin, bmax,
                         (build(order[:h]), build(order[h:])), ())

    root = build(keep) if len(keep) else None
    return _CullTree(always=always, root=root)


def _aabb_entry_exit(bmin, bmax, o, inv):
    """Slab test (wgsl :358-393): per-lane (t_near, t_far) for a constant
    box. Degenerate-direction NaNs fall out as non-hits in the compare."""
    tn = jnp.full_like(o[0], -np.float32(np.inf))
    tf = jnp.full_like(o[0], np.float32(np.inf))
    for c in range(3):
        t0 = (np.float32(bmin[c]) - o[c]) * inv[c]
        t1 = (np.float32(bmax[c]) - o[c]) * inv[c]
        tn = jnp.maximum(tn, jnp.minimum(t0, t1))
        tf = jnp.minimum(tf, jnp.maximum(t0, t1))
    return tn, tf


def _tree_leaves(node):
    if node is None:
        return []
    if node.prims:
        return [node]
    return [lf for ch in node.children for lf in _tree_leaves(ch)]


def _tree_sweep(node, o, inv, state, vote, t_cap, leaf_fn):
    """Whole-tile conditional sweep over the cull tree's LEAVES (DFS
    order): one lax.cond per leaf box. Gating the internal nodes too (true
    nested descent) costs more than it prunes: the top boxes almost never
    prune for a whole tile, so all the pruning power is at the leaves.

    vote(state) -> lanes whose result still matters; t_cap(state) ->
    per-lane upper bound on useful entry distance (current best hit /
    shadow range); leaf_fn(prims, state) -> state after the unrolled
    leaf sweep."""
    for leaf in _tree_leaves(node):
        tn, tf = _aabb_entry_exit(leaf.bmin, leaf.bmax, o, inv)
        # negated compares: a NaN slab test (d component exactly 0 with o
        # exactly on the plane -> 0*inf) must vote HIT (conservative — an
        # extra sweep never changes results; a dropped vote can cull a
        # leaf some lane actually hits)
        pred = _any(vote(state) & ~((tn > tf) | (tf <= 0.0)
                                    | (tn >= t_cap(state))))
        state = jax.lax.cond(
            pred,
            lambda st, lf=leaf: leaf_fn(lf.prims, st),
            lambda st: st,
            state)
    return state


def huge_sphere_mask(r: np.ndarray) -> np.ndarray:
    """Which radii count as scene-spanning (e.g. the r=1000 ground,
    lib.rs:233): they would bloat every cull-tree box, so they sweep flat."""
    med = float(np.median(r))
    return r > max(10.0 * med, 1e-3)


def _sphere_cull_tree(spheres, leaf_size: int) -> _CullTree:
    c = np.asarray([sp.c for sp in spheres], np.float32).reshape(-1, 3)
    r = np.asarray([sp.r for sp in spheres], np.float32).reshape(-1, 1)
    huge = huge_sphere_mask(r[:, 0]) if len(spheres) else np.zeros(0, bool)
    return _build_cull_tree(tuple(spheres), c - r, c + r, leaf_size, huge)


def _closest_sphere_clustered(tree: _CullTree, o, d, mask):
    a = s.vdot(d, d)
    state = _sweep_spheres_static(tree.always, o, d, a,
                                  _sphere_state_init(o))
    if tree.root is None:
        return _sphere_state_finish(o, d, state)
    inv = tuple(1.0 / d[c] for c in range(3))
    state = _tree_sweep(
        tree.root, o, inv, state,
        vote=lambda st: mask, t_cap=lambda st: st[0],
        leaf_fn=lambda prims, st: _sweep_spheres_static(prims, o, d, a, st))
    return _sphere_state_finish(o, d, state)


def _shadow_clustered(tree: _CullTree, o, d, t_max, lam, mask):
    a = s.vdot(d, d)
    atten = _shadow_sweep_static(tree.always, o, d, t_max, lam, a,
                                 jnp.ones_like(o[0]))
    if tree.root is None:
        return atten
    inv = tuple(1.0 / d[c] for c in range(3))
    # already-black lanes can't get darker: drop them from the vote
    return _tree_sweep(
        tree.root, o, inv, atten,
        vote=lambda at: mask & (at > 0.0), t_cap=lambda at: t_max,
        leaf_fn=lambda prims, at: _shadow_sweep_static(prims, o, d, t_max,
                                                       lam, a, at))


def _closest_sphere_dyn(sph_ref, S, o, d):
    """fori_loop winner sweep over a sphere table (S, 8) in device memory
    — used above the static-unroll budget, where baking every sphere into
    the instruction stream would make compile time grow with the count."""
    a = s.vdot(d, d)
    inv_a = 1.0 / a

    def body(si, carry):
        best_t, bcx, bcy, bcz, best_mat = carry
        cx, cy, cz = sph_ref[si, 0], sph_ref[si, 1], sph_ref[si, 2]
        r = sph_ref[si, 3]
        oc = (o[0] - cx, o[1] - cy, o[2] - cz)
        half_b = s.vdot(oc, d)
        c = s.vdot(oc, oc) - r * r
        disc = half_b * half_b - a * c
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t = (-half_b - sq) * inv_a
        t = jnp.where((disc > 0.0) & (t > 0.0) & (r > 0.0), t, MISS)
        better = t < best_t
        best_t = jnp.where(better, t, best_t)
        bcx = jnp.where(better, cx, bcx)
        bcy = jnp.where(better, cy, bcy)
        bcz = jnp.where(better, cz, bcz)
        best_mat = jnp.where(better, sph_ref[si, 4].astype(jnp.int32),
                             best_mat)
        return best_t, bcx, bcy, bcz, best_mat

    z = jnp.zeros_like(o[0])
    best_t, bcx, bcy, bcz, best_mat = jax.lax.fori_loop(
        0, S, body,
        (jnp.full_like(o[0], MISS), z, z, z,
         jnp.zeros_like(o[0], jnp.int32)))
    loc = s.vadd(o, s.vscale(d, best_t * 0.9999))
    nrm = s.vnormalize(s.vsub(loc, (bcx, bcy, bcz)), eps=1e-30)
    return best_t, loc, nrm, best_mat


def _shadow_dyn(sph_ref, S, o, d, t_max, lam):
    """fori_loop shadow sweep over the sphere table. Material types are
    runtime scalars here, so both the diffuse and dielectric factors are
    computed and selected (the static mode folds this away)."""
    a = s.vdot(d, d)
    inv_a = 1.0 / a
    cauchy = jnp.float32(DISPERSION_B) / ((lam * 1e-3) * (lam * 1e-3))

    def body(si, atten):
        cx, cy, cz = sph_ref[si, 0], sph_ref[si, 1], sph_ref[si, 2]
        r = sph_ref[si, 3]
        mtype = sph_ref[si, 5]
        ior = sph_ref[si, 6]
        cb = s.vbroadcast((cx, cy, cz), o[0])
        oc = s.vsub(o, cb)
        half_b = s.vdot(oc, d)
        c = s.vdot(oc, oc) - r * r
        disc = half_b * half_b - a * c
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t0 = (-half_b - sq) * inv_a
        t1 = (-half_b + sq) * inv_a
        overlap = (disc > 0.0) & (t1 > 0.0) & (t0 < t_max) & (r > 0.0)
        t_entry = jnp.maximum(t0, 0.0)
        t_exit = jnp.minimum(t1, t_max)
        segment = t_entry < t_exit
        eta = ior + cauchy
        p1 = s.vadd(o, s.vscale(d, t_entry))
        n1 = s.vnormalize(s.vsub(p1, cb), eps=1e-30)
        R1 = fr_dielectric(-s.vdot(n1, d), eta)
        p2 = s.vadd(o, s.vscale(d, t_exit))
        n2 = s.vnormalize(s.vsub(p2, cb), eps=1e-30)
        R2 = fr_dielectric(-s.vdot(n2, d), eta)
        diel = jnp.where(segment, (1.0 - R1) * (1.0 - R2), 1.0)
        # only dielectrics (mtype 1) transmit; diffuse and metal occlude
        f = jnp.where(mtype == 1.0, diel, jnp.zeros_like(diel))
        return atten * jnp.where(overlap, f, 1.0)

    return jax.lax.fori_loop(0, S, body, jnp.ones_like(o[0]))


def _sweep_tris_static(tris, o, d, state):
    """Unrolled Moller-Trumbore winner loop over constant triangles,
    continuing from `state` (wgsl :303-338, :395-428 — the brute-force
    equivalent of the BVH walk)."""
    best_t, best_n, best_mat = state
    for tr in tris:
        t, valid = s.triangle_hit_c(o, d, tr.a, tr.e1, tr.e2)
        t = jnp.where(valid, t, MISS)
        better = t < best_t
        best_t = jnp.where(better, t, best_t)
        best_n = s.vwhere(better, s.vbroadcast(tr.n, o[0]), best_n)
        best_mat = jnp.where(better, np.int32(tr.mat), best_mat)
    return best_t, best_n, best_mat


def _tri_state_init(o):
    return (jnp.full_like(o[0], MISS), (jnp.zeros_like(o[0]),) * 3,
            jnp.zeros_like(o[0], jnp.int32))


def _tri_state_finish(o, d, state):
    best_t, best_n, best_mat = state
    # hit point offset along the geometric normal like the reference
    loc = s.vadd(s.vadd(o, s.vscale(best_n, 1e-5)), s.vscale(d, best_t))
    return best_t, loc, best_n, best_mat


def _closest_tri_static(tris, o, d):
    return _tri_state_finish(o, d,
                             _sweep_tris_static(tris, o, d,
                                                _tri_state_init(o)))


def _tri_occ_sweep_static(tris, o, d, t_max, occluded):
    """Binary triangle occlusion (wgsl :540-562: all triangles block)."""
    for tr in tris:
        t, valid = s.triangle_hit_c(o, d, tr.a, tr.e1, tr.e2)
        occluded = occluded | (valid & (t < t_max))
    return occluded


def _tri_shadow_static(tris, o, d, t_max):
    return _tri_occ_sweep_static(tris, o, d, t_max,
                                 jnp.zeros_like(o[0], bool))


# ----- clustered triangle sweep (same tile-coherent cull tree) -----

def _tri_cull_tree(tris, leaf_size: int) -> _CullTree:
    if not tris:
        return _CullTree(always=(), root=None)
    verts = np.asarray(
        [[tr.a,
          [tr.a[c] + tr.e1[c] for c in range(3)],
          [tr.a[c] + tr.e2[c] for c in range(3)]] for tr in tris],
        np.float32)                      # (T, 3 verts, 3)
    lo, hi = verts.min(axis=1), verts.max(axis=1)
    diag = np.linalg.norm(hi - lo, axis=1)
    med = float(np.median(diag))
    huge = diag > max(10.0 * med, 1e-3)  # scene-spanning ground quads etc.
    return _build_cull_tree(tuple(tris), lo, hi, leaf_size, huge)


def _closest_tri_clustered(tree: _CullTree, o, d, mask):
    state = _sweep_tris_static(tree.always, o, d, _tri_state_init(o))
    if tree.root is None:
        return _tri_state_finish(o, d, state)
    inv = tuple(1.0 / d[c] for c in range(3))
    state = _tree_sweep(
        tree.root, o, inv, state,
        vote=lambda st: mask, t_cap=lambda st: st[0],
        leaf_fn=lambda prims, st: _sweep_tris_static(prims, o, d, st))
    return _tri_state_finish(o, d, state)


def _tri_shadow_clustered(tree: _CullTree, o, d, t_max, mask):
    occ = _tri_occ_sweep_static(tree.always, o, d, t_max,
                                jnp.zeros_like(o[0], bool))
    if tree.root is None:
        return occ
    inv = tuple(1.0 / d[c] for c in range(3))
    # the cond carry is an i32 mask, not bool (the _mask_i32 convention)
    occ_i = _tree_sweep(
        tree.root, o, inv, _mask_i32(occ),
        vote=lambda oc: mask & (oc == 0), t_cap=lambda oc: t_max,
        leaf_fn=lambda prims, oc: _mask_i32(
            _tri_occ_sweep_static(prims, o, d, t_max, oc > 0)))
    return occ_i > 0


def _closest_tri_dyn(tri_ref, T, o, d):
    """fori_loop MT winner sweep over a triangle table (T, 16):
    ax,ay,az, e1x,e1y,e1z, e2x,e2y,e2z, nx,ny,nz, mat, 0,0,0."""
    def body(ti, carry):
        best_t, bnx, bny, bnz, best_mat = carry
        a = (tri_ref[ti, 0], tri_ref[ti, 1], tri_ref[ti, 2])
        e1 = (tri_ref[ti, 3], tri_ref[ti, 4], tri_ref[ti, 5])
        e2 = (tri_ref[ti, 6], tri_ref[ti, 7], tri_ref[ti, 8])
        t, valid = s.triangle_hit_c(o, d, a, e1, e2)
        t = jnp.where(valid, t, MISS)
        better = t < best_t
        best_t = jnp.where(better, t, best_t)
        bnx = jnp.where(better, tri_ref[ti, 9], bnx)
        bny = jnp.where(better, tri_ref[ti, 10], bny)
        bnz = jnp.where(better, tri_ref[ti, 11], bnz)
        best_mat = jnp.where(better, tri_ref[ti, 12].astype(jnp.int32),
                             best_mat)
        return best_t, bnx, bny, bnz, best_mat

    z = jnp.zeros_like(o[0])
    best_t, bnx, bny, bnz, best_mat = jax.lax.fori_loop(
        0, T, body, (jnp.full_like(o[0], MISS), z, z, z,
                     jnp.zeros_like(o[0], jnp.int32)))
    n = (bnx, bny, bnz)
    loc = s.vadd(s.vadd(o, s.vscale(n, 1e-5)), s.vscale(d, best_t))
    return best_t, loc, n, best_mat


def _tri_shadow_dyn(tri_ref, T, o, d, t_max):
    def body(ti, occ):
        a = (tri_ref[ti, 0], tri_ref[ti, 1], tri_ref[ti, 2])
        e1 = (tri_ref[ti, 3], tri_ref[ti, 4], tri_ref[ti, 5])
        e2 = (tri_ref[ti, 6], tri_ref[ti, 7], tri_ref[ti, 8])
        t, valid = s.triangle_hit_c(o, d, a, e1, e2)
        return jnp.maximum(occ, _mask_i32(valid & (t < t_max)))
    occ = jax.lax.fori_loop(0, T, body, jnp.zeros_like(o[0], jnp.int32))
    return occ > 0


def _combine_nearest(h1, h2):
    """Nearest-of-two winner (ref: mega_kernel.wgsl:874-878)."""
    t1, loc1, n1, m1 = h1
    t2, loc2, n2, m2 = h2
    take2 = t2 < t1
    return (jnp.where(take2, t2, t1),
            s.vwhere(take2, loc2, loc1),
            s.vwhere(take2, n2, n1),
            jnp.where(take2, m2, m1))


def _single_lambda_em_c(lights, lam):
    """Per-light spectral emission at one wavelength, component form
    (ref: mega_kernel.wgsl:574-578): color*intensity*range * blackbody *
    cie_rgb. Returns a flat list of 3*L planes. This is both the C=1
    emission and the hero's post-collapse emission (the dispersive dirac
    continuation keeps FULL weight — only the hero technique can generate
    such a path, cf. pbrt-v4 SampledWavelengths::TerminateSecondary)."""
    cie = s.cie_to_rgb_c(lam)
    out = []
    for lt in lights:
        spd = (blackbody(lam, np.float32(lt.temp))
               if lt.temp > 0.0 else 1.0)
        for c in range(3):
            out.append(np.float32(lt.color[c] * lt.intensity
                                  * VISIBLE_RANGE) * spd * cie[c])
    return out


def _sky_em_c(cfg, lam):
    """Untinted spectral sky emission planes at lam, component form
    (EXTENSION — see integrate.sky_emission_rgb; the reference's sky is
    black, mega_kernel.wgsl:617-620). Same emission form as the lights."""
    cie = s.cie_to_rgb_c(lam)
    spd = (blackbody(lam, np.float32(cfg.sky_temp))
           if cfg.sky_temp > 0.0 else 1.0)
    k = np.float32(cfg.sky_intensity * VISIBLE_RANGE)
    return tuple(k * spd * cie[c] for c in range(3))


def _sky_tint_c(cfg, d):
    """cfg.sky_color as per-channel factors; with cfg.sky_gradient the
    tint lerps white -> (.5,.7,1) by direction height (the legacy
    wavefront ramp, wavefront.wgsl:129-131)."""
    if not cfg.sky_gradient:
        return tuple(np.float32(c) for c in cfg.sky_color)
    dn = s.vnormalize(d, eps=1e-30)
    t = 0.5 * (dn[1] + 1.0)
    return tuple(np.float32(cfg.sky_color[c])
                 * ((1.0 - t) + t * np.float32(g))
                 for c, g in enumerate((0.5, 0.7, 1.0)))


def _flat_em_c(lam):
    """Flat-spectrum emission base at lam (cie * range), component form —
    the lambda-only factor of type-3 emissive materials (the intensity is
    folded into the material color; see scene.Material.emissive)."""
    cie = s.cie_to_rgb_c(lam)
    return tuple(np.float32(VISIBLE_RANGE) * cie[c] for c in range(3))


def _is_emissive_static(materials, mat_id):
    """Per-lane type-3 mask via the same unrolled select chain as
    _material_lookup_static."""
    is_em = jnp.zeros_like(mat_id, bool)
    for m, mat in enumerate(materials):
        if mat.mtype == 3:
            is_em = is_em | (mat_id == m)
    return is_em


def _material_lookup_static(materials, mat_id):
    """Per-lane material attributes via an unrolled constant select chain.
    Returns (color, rough, ior, is_diffuse, is_metal)."""
    zero = jnp.zeros_like(mat_id, jnp.float32)
    cr, cg, cb_, rough, ior = zero, zero, zero, zero, zero
    is_diffuse = jnp.zeros_like(mat_id, bool)
    is_metal = jnp.zeros_like(mat_id, bool)
    for m, mat in enumerate(materials):
        sel = mat_id == m
        cr = jnp.where(sel, np.float32(mat.color[0]), cr)
        cg = jnp.where(sel, np.float32(mat.color[1]), cg)
        cb_ = jnp.where(sel, np.float32(mat.color[2]), cb_)
        rough = jnp.where(sel, np.float32(mat.rough), rough)
        ior = jnp.where(sel, np.float32(mat.ior), ior)
        if mat.mtype == 0:
            is_diffuse = is_diffuse | sel
        elif mat.mtype == 2:
            is_metal = is_metal | sel
    return (cr, cg, cb_), rough, ior, is_diffuse, is_metal


def nee_direct_c(LIGHTS, loc, n, lam, rng, shadow, shadow_mask_fn, emv_fn,
                 z3, mode="all"):
    """THE NEE light loop (wgsl :568-615) of the fused kernel body (the
    photon walk has no NEE). The shadow liveness mask and the emission
    source are injected as closures:

      shadow_mask_fn() -> mask plane, re-evaluated per light like the old
        inline `active & found & is_diffuse` chains;
      emv_fn(li) -> (r, g, b) emission for light li, called after that
        light's weight is ready (closures may load refs / select on
        collapse state in place).

    mode (static) = cfg.light_sample: "all" loops every light (reference
    semantics, 2 draws + 1 shadow segment per light); "power"/"spatial"
    delegate to the O(1)-shadow-rays branch below (3 draws + 1 shadow
    segment total).

    Returns (direct, rng): 2 rng draws consumed per light ("all" mode).
    """
    if mode in ("power", "spatial") and LIGHTS:
        return _nee_direct_power_c(LIGHTS, loc, n, lam, rng, shadow,
                                   shadow_mask_fn, emv_fn, z3, mode)
    direct = z3
    for li, lt in enumerate(LIGHTS):
        u1, rng = rngmod.rand_1f(rng)
        u2, rng = rngmod.rand_1f(rng)
        if lt.ltype == 1:
            su = (u1 - 0.5) * np.float32(2.0 * lt.hw)
            sv = (u2 - 0.5) * np.float32(2.0 * lt.hw)
            lp = tuple(
                np.float32(lt.pos[c]) + su * np.float32(lt.tangent[c])
                + sv * np.float32(lt.bitangent[c]) for c in range(3))
        else:
            lp = s.vbroadcast(lt.pos, u1)
        to_light = s.vsub(lp, loc)
        dist = jnp.sqrt(jnp.maximum(s.vdot(to_light, to_light), 1e-30))
        ldir = s.vscale(to_light, 1.0 / dist)
        ndotl = s.vdot(n, ldir)
        live = (dist >= EPS) & (ndotl > 0.0)
        if lt.ltype == 1:
            cos_light = jnp.maximum(
                0.0, -(lt.normal[0] * ldir[0] + lt.normal[1] * ldir[1]
                       + lt.normal[2] * ldir[2]))
            live = live & (cos_light > 0.0) & (lt.hw > 0.0)
            geom = ndotl * cos_light * np.float32(
                max(4.0 * lt.hw * lt.hw, 1e-10))
        else:
            geom = ndotl
        so = s.vadd(loc, s.vscale(n, EPS))
        atten = shadow(so, ldir, dist - EPS, lam, shadow_mask_fn() & live)
        w = jnp.where(live, geom * atten / (dist * dist), 0.0)
        direct = s.vadd(direct, s.vscale(emv_fn(li), w))
    return direct, rng


def _nee_direct_power_c(LIGHTS, loc, n, lam, rng, shadow, shadow_mask_fn,
                        emv_fn, z3, mode):
    """cfg.light_sample == "power"/"spatial" NEE for the fused kernels
    (EXTENSION; twin of integrate._sample_direct_power, same 3-draw
    layout: select uniform, then the 2f light sample). ONE selected
    light per lane, weighted by 1/pmf — one shadow sweep per bounce
    regardless of light count. "spatial" divides each base power by the
    lane's squared distance to the light center (unshadowed-contribution
    heuristic). The base power terms are compile-time constants here
    (frozen scene), traced scalars in the XLA path; the selection
    arithmetic is the same f32 chain either way (ops/sampling). Callers
    count ONE shadow segment per live lane.
    """
    from tpurt.ops.sampling import light_powers, select_from_powers
    u_sel, rng = rngmod.rand_1f(rng)
    powers = light_powers(
        [np.float32(lt.intensity) for lt in LIGHTS],
        [np.float32(lt.hw) for lt in LIGHTS],
        [lt.ltype == 1 for lt in LIGHTS])
    if mode == "spatial":
        sp = []
        for li, lt in enumerate(LIGHTS):
            dx = np.float32(lt.pos[0]) - loc[0]
            dy = np.float32(lt.pos[1]) - loc[1]
            dz = np.float32(lt.pos[2]) - loc[2]
            d2 = dx * dx + dy * dy + dz * dz
            sp.append(powers[li] / jnp.maximum(d2, jnp.float32(1e-4)))
        powers = sp
    sels, inv_pmf = select_from_powers(u_sel, powers)
    u1, rng = rngmod.rand_1f(rng)
    u2, rng = rngmod.rand_1f(rng)

    zero = jnp.zeros_like(u_sel)
    lp, lnorm_sel, emv = z3, z3, z3
    hw_sel, area_sel = zero, zero
    for li, lt in enumerate(LIGHTS):
        if lt.ltype == 1:
            su = (u1 - 0.5) * np.float32(2.0 * lt.hw)
            sv = (u2 - 0.5) * np.float32(2.0 * lt.hw)
            lp_i = tuple(
                np.float32(lt.pos[c]) + su * np.float32(lt.tangent[c])
                + sv * np.float32(lt.bitangent[c]) for c in range(3))
        else:
            lp_i = s.vbroadcast(lt.pos, u_sel)
        m = sels[li]
        lp = s.vwhere(m, lp_i, lp)
        lnorm_sel = s.vwhere(m, s.vbroadcast(lt.normal, u_sel), lnorm_sel)
        hw_sel = jnp.where(m, np.float32(lt.hw), hw_sel)
        area_sel = jnp.where(m, np.float32(1.0 if lt.ltype == 1 else 0.0),
                             area_sel)
        emv = s.vwhere(m, emv_fn(li), emv)

    to_light = s.vsub(lp, loc)
    dist = jnp.sqrt(jnp.maximum(s.vdot(to_light, to_light), 1e-30))
    ldir = s.vscale(to_light, 1.0 / dist)
    ndotl = s.vdot(n, ldir)
    is_area = area_sel > 0.5
    cos_light = jnp.maximum(0.0, -(lnorm_sel[0] * ldir[0]
                                   + lnorm_sel[1] * ldir[1]
                                   + lnorm_sel[2] * ldir[2]))
    live = (dist >= EPS) & (ndotl > 0.0)
    # area lights also require a front-facing sample point and a positive half-width
    live = live & (~is_area | ((cos_light > 0.0) & (hw_sel > 0.0)))
    inv_pdf = jnp.where(is_area,
                        jnp.maximum(4.0 * hw_sel * hw_sel, 1e-10),
                        jnp.float32(1.0))
    geom = ndotl * jnp.where(is_area, cos_light, jnp.float32(1.0))
    so = s.vadd(loc, s.vscale(n, EPS))
    atten = shadow(so, ldir, dist - EPS, lam, shadow_mask_fn() & live)
    w = jnp.where(live,
                  geom * atten * inv_pdf * inv_pmf / (dist * dist), 0.0)
    return s.vscale(emv, w), rng


def scatter_rr_c(cfg, wo, n, loc, color, rough, is_diffuse, is_metal, tp,
                 rng, *, any_dielectric, any_metal, eta_fn, camera_pdf,
                 rr_thresh_fn, strata_fn=None, post_dielectric=None,
                 rr_scale_fn=None):
    """THE scatter-select + Russian-roulette block (wgsl :906-979 camera,
    :782-853 photon) of the fused kernel body. Per-site variation is
    injected as closures:

      eta_fn() -> dielectric eta plane (dispersion rule differs per phase;
        camera and photon lanes disperse differently);
      camera_pdf: bool or per-lane plane (regen mixes phases per lane);
      rr_thresh_fn() -> RR threshold (scalar const, or the regen kernel's
        per-lane camera/photon select);
      strata_fn(u2a, u2b, u_choice) -> remapped triple (bounce strata);
      post_dielectric(is_diel) -> arbitrary extra (hero-collapse updates),
        returned as `extra`;
      rr_scale_fn() -> RR survival-probability scale (scalar const, or a
        per-lane camera/photon select) for cfg.photon_rr_scale != 1.0;
        None (the default, and ALWAYS at scale 1.0) emits the reference's
        RR ops unchanged.

    Consumes exactly 4 rng draws. Returns
    (wi, new_tp, new_o, scat_ok, rr_live, rng, extra).
    """
    u2a, rng = rngmod.rand_1f(rng)
    u2b, rng = rngmod.rand_1f(rng)
    u_choice, rng = rngmod.rand_1f(rng)
    u_rr, rng = rngmod.rand_1f(rng)
    if strata_fn is not None:
        u2a, u2b, u_choice = strata_fn(u2a, u2b, u_choice)

    wi_d, tpm_d = diffuse_scatter_c(wo, n, color, rough, u2a, u2b)
    wi, tpm = wi_d, tpm_d
    off = jnp.full_like(u2a, EPS)
    scat_ok = jnp.ones_like(u2a, bool)
    alpha = jnp.sqrt(rough)
    extra = None
    if any_dielectric:
        wi_s, tpm_s, off_s, valid_s = scatter_dielectric_c(
            wo, n, eta_fn(), alpha, u2a, u2b, u_choice,
            camera_pdf=camera_pdf)
        is_diel = ~(is_diffuse | is_metal)
        wi = s.vwhere(is_diel, wi_s, wi)
        tpm = s.vwhere(is_diel, (tpm_s, tpm_s, tpm_s), tpm)
        off = jnp.where(is_diel, off_s, off)
        scat_ok = (is_diel & valid_s) | (~is_diel & scat_ok)
        if post_dielectric is not None:
            extra = post_dielectric(is_diel)
    if any_metal:
        wi_m, tpm_m, valid_m = scatter_metal_c(wo, n, color, alpha,
                                                u2a, u2b)
        wi = s.vwhere(is_metal, wi_m, wi)
        tpm = s.vwhere(is_metal, tpm_m, tpm)
        scat_ok = (is_metal & valid_m) | (~is_metal & scat_ok)

    new_tp = s.vmul(tp, tpm)
    new_o = s.vadd(loc, s.vscale(n, off))
    prob = s.vmax_comp(new_tp)
    if rr_scale_fn is None:
        rr_live = (prob >= rr_thresh_fn()) & (u_rr <= prob)
        new_tp = s.vscale(new_tp, 1.0 / jnp.maximum(prob, 1e-30))
    else:
        # EXTENSION (cfg.photon_rr_scale): extra thinning composed with
        # the reference's RR — survive with min(prob,1)*sc, reweight by
        # 1/(prob*sc); per-bounce expectation equals the reference's for
        # every prob (twin of integrate.scatter_and_rr, see the rationale
        # there). Lanes with sc == 1 (regen camera lanes) reduce exactly
        # to the reference ops: u_rr < 1 makes the min(prob,1) kill
        # equivalent to the unclamped one, and the division is by prob.
        sc = rr_scale_fn()
        p = jnp.minimum(prob, jnp.float32(1.0)) * sc
        rr_live = (prob >= rr_thresh_fn()) & (u_rr <= p)
        new_tp = s.vscale(new_tp, 1.0 / jnp.maximum(prob * sc, 1e-30))
    return wi, new_tp, new_o, scat_ok, rr_live, rng, extra


def _use_clusters(fscene: FrozenScene, cfg: RenderConfig) -> bool:
    return (cfg.pallas_cluster_size > 0
            and len(fscene.spheres) > 4 * cfg.pallas_cluster_size
            and len(fscene.spheres) <= cfg.pallas_static_unroll)


def _prim_tables(fscene: FrozenScene, cfg: RenderConfig):
    """Device-memory primitive tables, read only above the static-unroll
    budget. spheres: (cx, cy, cz, r, mat, mtype, ior, 0); triangles: (a,
    e1, e2, n, mat, pad3). A one-row zero table stands in otherwise."""
    if len(fscene.spheres) > cfg.pallas_static_unroll:
        sph_tab = jnp.asarray(
            [[sp.c[0], sp.c[1], sp.c[2], sp.r,
              float(sp.mat), float(sp.mtype), sp.ior, 0.0]
             for sp in fscene.spheres], jnp.float32)
    else:
        sph_tab = jnp.zeros((1, 8), jnp.float32)
    if len(fscene.triangles) > cfg.pallas_static_unroll:
        tri_tab = jnp.asarray(
            [list(tr.a) + list(tr.e1) + list(tr.e2) + list(tr.n)
             + [float(tr.mat), 0.0, 0.0, 0.0]
             for tr in fscene.triangles], jnp.float32)
    else:
        tri_tab = jnp.zeros((1, 16), jnp.float32)
    return sph_tab, tri_tab


def _make_scene_fns(fscene: FrozenScene, cfg: RenderConfig, sph_ref, tri_ref):
    """(intersect, shadow) closures over the frozen scene + primitive
    tables, picking clustered / static-unroll / table-sweep mode per
    primitive kind. Both take a lanes-relevance mask (the lanes whose
    result is consumed), used only for tile-level culling votes — per-lane
    results for masked-out lanes stay well-defined."""
    SPH, TRIS = fscene.spheres, fscene.triangles
    if _use_clusters(fscene, cfg):
        CL = _sphere_cull_tree(SPH, cfg.pallas_cluster_size)
        sph_hit = lambda o, d, m: _closest_sphere_clustered(CL, o, d, m)
        sph_shadow = lambda o, d, tm, lam_, m: _shadow_clustered(
            CL, o, d, tm, lam_, m)
    elif len(SPH) > cfg.pallas_static_unroll:
        sph_hit = lambda o, d, m: _closest_sphere_dyn(sph_ref, len(SPH), o, d)
        sph_shadow = lambda o, d, tm, lam_, m: _shadow_dyn(
            sph_ref, len(SPH), o, d, tm, lam_)
    else:
        sph_hit = lambda o, d, m: _closest_sphere_static(SPH, o, d)
        sph_shadow = lambda o, d, tm, lam_, m: _shadow_static(
            SPH, o, d, tm, lam_)
    if not TRIS:
        return sph_hit, sph_shadow
    tri_clusters = (cfg.pallas_cluster_size > 0
                    and len(TRIS) > 4 * cfg.pallas_cluster_size
                    and len(TRIS) <= cfg.pallas_static_unroll)
    if tri_clusters:
        TCL = _tri_cull_tree(TRIS, cfg.pallas_cluster_size)
        tri_hit = lambda o, d, m: _closest_tri_clustered(TCL, o, d, m)
        tri_occ = lambda o, d, tm, m: _tri_shadow_clustered(TCL, o, d, tm, m)
    elif len(TRIS) > cfg.pallas_static_unroll:
        tri_hit = lambda o, d, m: _closest_tri_dyn(tri_ref, len(TRIS), o, d)
        tri_occ = lambda o, d, tm, m: _tri_shadow_dyn(
            tri_ref, len(TRIS), o, d, tm)
    else:
        tri_hit = lambda o, d, m: _closest_tri_static(TRIS, o, d)
        tri_occ = lambda o, d, tm, m: _tri_shadow_static(TRIS, o, d, tm)

    def intersect(o, d, m):
        return _combine_nearest(sph_hit(o, d, m), tri_hit(o, d, m))

    def shadow(o, d, tm, lam_, m):
        return jnp.where(tri_occ(o, d, tm, m), 0.0,
                         sph_shadow(o, d, tm, lam_, m))

    return intersect, shadow


# ----- RenderState <-> planes conversion (XLA side) -----

def block_grid(cfg: RenderConfig):
    """(nbx, nby) image-block tile grid, or None for linear slab tiles."""
    if not cfg.pallas_block_tiles:
        return None
    R = cfg.pallas_lanes // 128
    return (-(-cfg.width // 128), -(-cfg.height // R))


def pixels_to_planes_order(cfg: RenderConfig, flat):
    """Linear-pixel-order channels (C, P) -> plane-order (C, P): each tile
    becomes an (R x 128) image block (row-major over the block grid).
    Identity when block tiles are off. Pure permutation — exact inverse of
    planes_pixel_order."""
    g = block_grid(cfg)
    if g is None:
        return flat
    nbx, nby = g
    R = cfg.pallas_lanes // 128
    C, P = flat.shape
    img = flat[:, :cfg.n_pixels].reshape(C, cfg.height, cfg.width)
    img = jnp.pad(img, ((0, 0), (0, nby * R - cfg.height),
                        (0, nbx * 128 - cfg.width)))
    out = img.reshape(C, nby, R, nbx, 128).transpose(0, 1, 3, 2, 4)
    out = out.reshape(C, nbx * nby * cfg.pallas_lanes)
    if P > out.shape[1]:  # n_dev-rounding tiles carry no pixels
        out = jnp.pad(out, ((0, 0), (0, P - out.shape[1])))
    return out


def planes_pixel_order(cfg: RenderConfig, flat):
    """Plane-order channels (C, P) -> linear-pixel-order (C, P)."""
    g = block_grid(cfg)
    if g is None:
        return flat
    nbx, nby = g
    R = cfg.pallas_lanes // 128
    C, P = flat.shape
    body = flat[:, : nbx * nby * cfg.pallas_lanes]
    img = body.reshape(C, nby, nbx, R, 128).transpose(0, 1, 3, 2, 4)
    img = img.reshape(C, nby * R, nbx * 128)[:, :cfg.height, :cfg.width]
    out = img.reshape(C, cfg.n_pixels)
    if P > cfg.n_pixels:
        out = jnp.pad(out, ((0, 0), (0, P - cfg.n_pixels)))
    return out


def state_to_planes(state, cfg: RenderConfig):
    """RenderState arrays (P, 3)/(P,) -> (16, TR, 128) f32 planes (block
    order when cfg.pallas_block_tiles)."""
    P = state.rgb_sum.shape[0]
    TR = P // 128
    cols = [state.rgb_sum[:, c] for c in range(3)]
    for arr in (state.vis_pos, state.vis_norm, state.vis_wo, state.vis_tp):
        cols.extend(arr[:, c] for c in range(3))
    cols.append(state.vis_mat.astype(jnp.float32))
    flat = pixels_to_planes_order(cfg, jnp.stack(cols))
    return flat.reshape(N_CHANNELS, TR, 128)
