"""Counter-free PCG (RXS-M-XS 32/32) random number generation, vectorized.

Bit-exact reimplementation of the in-shader hash used by the reference
renderer (ref: src/kernels/mega_kernel.wgsl:655-675, stream seeding at :991),
but written as pure functions over uint32 *arrays* so the same code runs

  * in plain jnp (CPU oracle / XLA path),
  * inside Pallas kernels (plain uint32 ALU ops),
  * under vmap/jit without host syncs.

State threading is explicit: every sampler takes a uint32 state array and
returns (value, new_state).  There is no global RNG.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# f32(0xFFFFFFFFu) rounds to 4294967296.0 in float32; the reference divides by
# that rounded constant, so we use the identical factor for bit-exact floats.
# (numpy scalars, not jnp arrays: Pallas kernels may not capture device
# arrays as closure constants.)
_INV_U32 = np.float32(1.0 / 4294967296.0)

_MUL = np.uint32(747796405)
_INC = np.uint32(2891336453)
_XSH_MUL = np.uint32(277803737)

TWO_PI = 6.283185307179586


def _bitcast_u32(x):
    """int32 -> uint32 reinterpret (a bitcast, never a value cast)."""
    if x.dtype == jnp.uint32:
        return x
    return jax.lax.bitcast_convert_type(x, jnp.uint32)


def _u32_to_f32(bits):
    """Exact uint32 -> float32 value conversion without a u32->f32 cast
    (kept to two signed 16-bit halves). hi*2^16 and lo are exact f32, so the single
    rounding of their sum equals rounding the 32-bit integer directly —
    bit-identical to f32(bits) on every backend."""
    i = jax.lax.bitcast_convert_type(bits, jnp.int32)
    hi = jax.lax.shift_right_logical(i, 16)
    lo = jax.lax.bitwise_and(i, jnp.int32(0xFFFF))
    return hi.astype(jnp.float32) * jnp.float32(65536.0) + lo.astype(jnp.float32)


def seed_pixels(seed, x, y):
    """Per-pixel RNG stream: seed + 1203793*x + 7*y (ref: mega_kernel.wgsl:991)."""
    seed = jnp.asarray(seed, jnp.uint32)
    x = _bitcast_u32(x)
    y = _bitcast_u32(y)
    return seed + jnp.uint32(1203793) * x + jnp.uint32(7) * y


# Golden-ratio offsets decorrelate the photon streams from the camera
# stream and from each other.
_PHOTON_OFFSET = np.uint32(0x9E3779B9)
_PHOTON_K_STEP = np.uint32(0x85EBCA6B)


def photon_stream(seed, x, y, k: int = 0):
    """Per-pixel stream for photon walk k, seeded independently of the
    camera path AND of the other photons. The reference continues one
    stream through everything (mega_kernel.wgsl:998); independent streams
    are statistically equivalent but make every draw position a pure
    function of (pixel, sample, phase, k) — invariant to how many draws
    other lanes or phases consumed. That keeps the XLA integrator, the
    Pallas megakernel, and the regenerative kernels same-seed comparable
    at ANY depth, tile size, or scheduling order.

    `k` may be a Python int or an i32 plane (the regenerative kernel
    spawns all pending photon indices in one vectorized pass); both forms
    produce identical streams (same modular uint32 arithmetic)."""
    if isinstance(k, (int, np.integer)):
        # python ints avoid numpy overflow warnings
        off = np.uint32((0x9E3779B9 + int(k) * 0x85EBCA6B) & 0xFFFFFFFF)
    else:
        off = (_PHOTON_OFFSET
               + jnp.asarray(k, jnp.int32).astype(jnp.uint32) * _PHOTON_K_STEP)
    return seed_pixels(jnp.asarray(seed, jnp.uint32) + off, x, y)


def rand_u32(state):
    """One PCG RXS-M-XS step. Returns (uint32 output, new state).

    Matches the reference exactly: the output is hashed from the *old* state,
    then the LCG advances (ref: mega_kernel.wgsl:655-660).
    """
    old = state.astype(jnp.uint32)
    shift = (old >> jnp.uint32(28)) + jnp.uint32(4)
    res = ((old >> shift) ^ old) * _XSH_MUL
    out = (res >> jnp.uint32(22)) ^ res
    new_state = old * _MUL + _INC
    return out, new_state


def rand_1f(state):
    """Uniform float32 in [0, 1). (ref: mega_kernel.wgsl:662-664).

    Dispatch: a state exposing ``next_1f`` (ops.qmc.QmcStream) draws from
    its own sequence instead — so the camera/lens helpers thread either
    stream kind unchanged (cfg.qmc swaps the spawn draws only)."""
    nxt = getattr(state, "next_1f", None)
    if nxt is not None:
        return nxt()
    bits, state = rand_u32(state)
    return _u32_to_f32(bits) * _INV_U32, state


def rand_2f(state):
    """Two uniforms, stacked on a trailing axis of size 2."""
    u1, state = rand_1f(state)
    u2, state = rand_1f(state)
    return jnp.stack([u1, u2], axis=-1), state


def unit_vec_from_u(u):
    """Uniform sphere direction from a (..., 2) uniform pair:
    theta = 2*pi*u1, phi = acos(1 - 2*u2) (ref: mega_kernel.wgsl:670-675).
    The acos cancels algebraically (cos(acos z) = z, sin(acos z) = sqrt(1-z^2))
    — cheaper than evaluating it."""
    theta = jnp.float32(TWO_PI) * u[..., 0]
    z = jnp.clip(1.0 - 2.0 * u[..., 1], -1.0, 1.0)
    sp = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    v = jnp.stack([sp * jnp.cos(theta), sp * jnp.sin(theta), z], axis=-1)
    return v.astype(jnp.float32)


def rand_unit_vec(state):
    """Uniform direction on the unit sphere. Returns ((..., 3), new state)."""
    u, state = rand_2f(state)
    return unit_vec_from_u(u), state


# tile-coherent photon emission (cfg.photon_strata) — extension over the
# reference, see docs/DESIGN.md
_STRATA_OFFSET = 0xA511E9B3
_STRATA_K_STEP = 0x632BE5AB


def _check_strata(n: int, what: str, wide: bool = False):
    # power-of-two: the bit-mask extraction below covers every stratum
    # uniformly; other n silently NEVER sample some cells (biased image).
    # <= 256: the four index fields live in disjoint 8-bit lanes of h.
    # Direction counts may go `wide` (a second hash word supplies two
    # 16-bit fields), capped at 4096: the (s + u) * inv remap keeps only
    # ~24 - log2(n) mantissa bits of u inside a cell, so finer n starts
    # quantizing the within-cell uniform (a real f32 bias, not hygiene).
    cap = 4096 if wide else 256
    if not (0 < n <= cap and (n & (n - 1)) == 0):
        raise ValueError(
            f"{what} must be a power of two in [1, {cap}], got {n}")


def emission_strata(seed, k: int, n_pos: int, n_dir: int):
    """Four stratum indices as exact f32s: (pos_u, pos_v) in [0, n_pos)
    and (dir_a, dir_b) in [0, n_dir) for photon emission stratification
    (powers of two).

    A pure function of the FRAME seed and photon index k only — pixel-
    independent, so every lane of a tile (and every backend) emitting its
    (sample, k) photon shares ONE position patch and direction cell. The
    emitted photons stay exactly light-distributed across samples (the
    stratum is hash-uniform per sample); within a sample they are
    correlated, which is the point: coherent first photon segments that
    the whole-tile culling votes can prune.  Direction cells are decoupled
    from position cells because they dominate the beam footprint: a light
    tens of units from the scene turns even a small angular cell into a
    wide beam, so n_dir usually wants to be much finer than n_pos."""
    _check_strata(n_pos, "photon_strata")
    _check_strata(n_dir, "photon_strata_dir", wide=True)
    if isinstance(k, (int, np.integer)):
        off = np.uint32((_STRATA_OFFSET + int(k) * _STRATA_K_STEP)
                        & 0xFFFFFFFF)
    else:  # i32 plane (vectorized photon spawn) — same modular arithmetic
        off = (np.uint32(_STRATA_OFFSET)
               + jnp.asarray(k, jnp.int32).astype(jnp.uint32)
               * np.uint32(_STRATA_K_STEP))
    s = jnp.asarray(seed, jnp.uint32) + off
    h, s2 = rand_u32(s)
    mp = jnp.uint32(n_pos - 1)
    md = jnp.uint32(n_dir - 1)
    if n_dir <= 256:
        da, db = (h >> jnp.uint32(16)) & md, (h >> jnp.uint32(24)) & md
    else:  # wide direction cells: two 16-bit fields from a second word
        h2, _ = rand_u32(s2)
        da, db = h2 & md, (h2 >> jnp.uint32(16)) & md
    idx = (h & mp, (h >> jnp.uint32(8)) & mp, da, db)
    return tuple(_u32_to_f32(i) for i in idx)


# largest f32 below 1.0: the remap must keep uniforms inside [0, 1)
# (s + u can round up to n exactly when u is within an ulp of 1)
_BELOW_ONE = np.float32(np.nextafter(np.float32(1.0), np.float32(0.0)))


def strata_counts(cfg) -> tuple[int, int]:
    """(n_pos, n_dir) from a RenderConfig: photon_strata_dir == 0 means
    'same as photon_strata' (the round-1 behavior)."""
    n_pos = int(cfg.photon_strata)
    n_dir = int(getattr(cfg, "photon_strata_dir", 0)) or n_pos
    return n_pos, n_dir


def strata_epoch(cfg, iteration):
    """Windowed global sample index for the stratum seed: samples inside a
    photon_strata_window-long run share one cell epoch.  `iteration` may be
    a scalar or a per-lane plane (the regen kernel's local sample counter
    plus its starting iteration)."""
    w = max(1, int(getattr(cfg, "photon_strata_window", 1)))
    if w & (w - 1):
        # the bitmask below only windows correctly for powers of two; e.g.
        # w=12 would REPEAT epochs (0,0,0,0,4,4,4,4,0,...) so early samples'
        # hash-chosen cells get re-drawn — systematic bias, not noise
        raise ValueError(
            f"photon_strata_window must be a power of two, got {w}")
    if w == 1:
        return iteration
    return iteration & jnp.int32(~(w - 1))


def strata_k(cfg, k: int) -> int:
    """The photon index the stratum hash sees.  photon_strata_shared_k
    folds all K photons of a sample into ONE emission cell — the whole
    photon phase of a tile becomes a single beam, which matters for the
    regenerative kernel where lanes interleave different k at any instant.
    Unbiasedness is unchanged (the cell is still hash-uniform per sample);
    a sample's photons become mutually correlated, raising per-sample
    variance slightly."""
    return 0 if getattr(cfg, "photon_strata_shared_k", False) else k


def apply_emission_strata(seed, k: int, n_pos: int, n_dir: int,
                          uc, up1, ue1, ue2, uh1, uh2):
    """Remap the six photon-emission uniforms into their (sample, k)
    stratum cell. THE cross-backend pairing contract — used verbatim by
    the XLA integrator and both megakernels: cone polar uc and hemisphere
    theta uh1 share da; cone azimuth up1 and hemisphere radius uh2 share
    db; quad position (ue1, ue2) gets (pu, pv). Results stay in [0, 1)."""
    pu, pv, da, db = emission_strata(seed, k, n_pos, n_dir)
    inv_p = np.float32(1.0 / n_pos)
    inv_d = np.float32(1.0 / n_dir)

    def r(u, s, inv):
        return jnp.minimum((s + u) * inv, _BELOW_ONE)

    return (r(uc, da, inv_d), r(up1, db, inv_d), r(ue1, pu, inv_p),
            r(ue2, pv, inv_p), r(uh1, da, inv_d), r(uh2, db, inv_d))


# bounce-level strata (cfg.photon_strata_bounce): a distinct hash domain
# so bounce cells never correlate with emission cells
_BOUNCE_OFFSET = 0x7F4A7C15
_BOUNCE_STEP = 0x94D049BB
# the camera path's bounce-cell key (cfg.camera_strata_bounce): photon
# cells key on k in [0, K); this constant keeps camera cells disjoint
CAMERA_STRATA_K = 0x5BD1



def apply_bounce_strata(seed, k, bounce, n_dir: int, ua, ub, uch):
    """Remap a photon BOUNCE's scatter uniforms (diffuse/GGX u2 pair +
    the reflect/refract choice) into a tile-shared (sample, k, bounce)
    cell — the depth extension of apply_emission_strata: an emission beam
    that stays tight keeps similar hit normals, so sharing the scatter
    cell keeps the SECOND and later photon segments tile-coherent too
    (culling votes keep pruning where per-lane scatter would decohere).

    Unbiased across samples by the emission-strata argument (the cell is
    hash-uniform per sample and independent of every lane's own draws;
    the remap is a measure-preserving bijection on [0,1)).  Within a
    sample a photon's bounce chain is shared — variance shifts into
    cross-sample noise.  The RR uniform is NOT remapped (termination
    stays per-lane).  `k`/`bounce` may be Python ints or i32 planes (the
    regenerative kernel interleaves both across lanes)."""
    _check_strata(n_dir, "photon_strata bounce cells", wide=True)
    s0 = (jnp.asarray(seed, jnp.uint32) + np.uint32(_BOUNCE_OFFSET)
          + jnp.asarray(k, jnp.uint32) * np.uint32(_STRATA_K_STEP)
          + jnp.asarray(bounce, jnp.uint32) * np.uint32(_BOUNCE_STEP))
    h, s1 = rand_u32(s0)
    md = jnp.uint32(n_dir - 1)
    if n_dir <= 256:
        da_b, db_b, dc_b = h & md, (h >> jnp.uint32(8)) & md, \
            (h >> jnp.uint32(16)) & md
    else:  # wide cells: 16-bit fields, third from a second hash word
        h2, _ = rand_u32(s1)
        da_b, db_b, dc_b = h & md, (h >> jnp.uint32(16)) & md, h2 & md
    da = _u32_to_f32(da_b)
    db = _u32_to_f32(db_b)
    dc = _u32_to_f32(dc_b)
    inv = np.float32(1.0 / n_dir)

    def r(u, s):
        return jnp.minimum((s + u) * inv, _BELOW_ONE)

    return r(ua, da), r(ub, db), r(uch, dc)
