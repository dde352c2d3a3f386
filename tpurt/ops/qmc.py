"""Owen-scrambled Sobol sampling for the camera-spawn draws (cfg.qmc).

EXTENSION over the reference, which draws every uniform from the per-pixel
PCG stream (ref: src/kernels/mega_kernel.wgsl:655-675, seeding :991). With
``RenderConfig.qmc=True`` the CAMERA-SPAWN uniforms — pixel jitter,
shutter time, lens disc, wavelength — come instead from a per-pixel
Owen-scrambled Sobol sequence indexed by the *global sample number*;
every later draw (path scatter, NEE, photons, RR) keeps the unchanged PCG
streams. Spawn dimensions are exactly where sample stratification pays:
the low-discrepancy points cover the pixel footprint / lens disc /
shutter interval / visible spectrum evenly across samples instead of
clumping like independent uniforms, so antialiased edges, depth of
field, motion blur and single-λ spectral noise converge at up to
O(N^-1.5) instead of O(N^-0.5).

Design (Burley, "Practical Hash-based Owen Scrambling", JCGT 2020):

  * Sobol points in 6 dimensions (dim 0 = van der Corput; dims 1-5 from
    the Joe-Kuo direction numbers), evaluated by XOR-folding direction
    numbers over the index bits — pure uint32 ALU, so the same code runs
    in jnp and inside Pallas kernels (like ops/rng.py).
  * Per-(pixel, dimension) Owen scrambling via the Laine-Karras hash:
    each pixel sees its own randomization of the shared point set, which
    breaks cross-pixel correlation while preserving every elementary-
    interval (stratification) property within a pixel.
  * The scramble seed derives from the render's BASE seed only — never
    the frame seed — so sample i of a pixel is a pure function of
    (base_seed, pixel, i, dim): all backends (XLA, tile-sync megakernel,
    regenerative megakernel, wavefront) produce bit-identical spawn
    draws for the same global sample index, regardless of scheduling.

Unbiasedness: for a uniformly hashed seed the Laine-Karras permutation
composed with ``x += seed`` maps any input to a uniform uint32 (each
step is a bijection), so every individual draw is marginally U[0,1) —
the estimator's expectation is unchanged; only the joint distribution
across samples changes (negatively correlated = variance reduction).

The stream object below quacks like the PCG state: ``ops.rng.rand_1f`` /
``rand_2f`` dispatch on it, so `camera.lens_perturb*` and
`spawn_camera_rays` thread it unchanged.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from tpurt.ops import rng as rngmod

# ----- Sobol direction numbers -----

# (s, a, m[1..s]) per Joe-Kuo ("new-joe-kuo-6"): primitive polynomial
# degree s, coefficient bits a, initial direction integers m. Dim 0 is
# the van der Corput radical inverse (no table needed).
_JOE_KUO = (
    (1, 0, (1,)),
    (2, 1, (1, 3)),
    (3, 1, (1, 3, 1)),
    (3, 2, (1, 1, 1)),
    (4, 1, (1, 1, 3, 3)),
)

N_DIMS = 1 + len(_JOE_KUO)  # jitter x/y, time, lens u/v, wavelength


def _direction_table() -> np.ndarray:
    """(N_DIMS, 32) uint32 direction numbers v_k (MSB-aligned)."""
    dims = [[1 << (31 - k) for k in range(32)]]
    for s, a, m_init in _JOE_KUO:
        m = list(m_init)
        for k in range(s, 32):
            x = m[k - s] ^ (m[k - s] << s)
            for j in range(1, s):
                if (a >> (s - 1 - j)) & 1:
                    x ^= m[k - j] << j
            m.append(x)
        dims.append([m[k] << (31 - k) for k in range(32)])
    return (np.asarray(dims, np.uint64) & 0xFFFFFFFF).astype(np.uint32)


_DIRS = _direction_table()


def sobol_u32(idx, dim: int):
    """Sobol point `idx` of dimension `dim` as uint32 bits (MSB = first
    binary digit of the fraction). idx: uint32 array/scalar; dim static.
    XOR-fold over the 32 index bits — unrolled uint32 ALU, Pallas-safe."""
    idx = jnp.asarray(idx, jnp.uint32)
    acc = jnp.zeros_like(idx)
    for b in range(32):
        bit = (idx >> jnp.uint32(b)) & jnp.uint32(1)
        # bit * v: cheap masked XOR operand (0 or v) without a select
        acc = acc ^ (bit * np.uint32(_DIRS[dim, b]))
    return acc


# ----- Owen scrambling (hash-based nested uniform scramble) -----

_M55 = np.uint32(0x55555555)
_M33 = np.uint32(0x33333333)
_M0F = np.uint32(0x0F0F0F0F)
_MFF = np.uint32(0x00FF00FF)


def reverse_bits_u32(x):
    """Bit-reverse a uint32 (SWAR, 5 steps)."""
    x = ((x >> jnp.uint32(1)) & _M55) | ((x & _M55) << jnp.uint32(1))
    x = ((x >> jnp.uint32(2)) & _M33) | ((x & _M33) << jnp.uint32(2))
    x = ((x >> jnp.uint32(4)) & _M0F) | ((x & _M0F) << jnp.uint32(4))
    x = ((x >> jnp.uint32(8)) & _MFF) | ((x & _MFF) << jnp.uint32(8))
    return (x >> jnp.uint32(16)) | (x << jnp.uint32(16))


def _laine_karras(x, seed):
    """Laine-Karras-style permutation (Burley 2020 §3 hash): every output
    bit depends only on its own and LOWER input bits — after a bit
    reversal that is exactly the Owen-tree 'flip each node by its
    prefix' structure. Each step is a bijection (adding a function of
    strictly lower bits), so a uniform seed gives a uniform output."""
    x = x + seed
    x = x ^ (x * np.uint32(0x6C50B47C))
    x = x ^ (x * np.uint32(0xB82F1E52))
    x = x ^ (x * np.uint32(0xC7AFE638))
    x = x ^ (x * np.uint32(0x8D22F6E6))
    return x


def owen_scramble_u32(bits, seed):
    """Owen-scramble Sobol fraction bits with a per-(pixel, dim) seed."""
    x = reverse_bits_u32(bits)
    x = _laine_karras(x, seed)
    return reverse_bits_u32(x)


# ----- The spawn-draw stream -----

_QMC_SALT = np.uint32(0x5173B0C1)   # decouples the scramble-seed hash
_DIM_STEP = np.uint32(0x9E3779B9)   # from every PCG stream family


@dataclasses.dataclass(frozen=True)
class QmcStream:
    """Spawn-draw stream: `rand_1f`-compatible (ops.rng dispatches on the
    ``next_1f`` attribute). ``dim`` is static Python — each traced draw
    site consumes a fixed Sobol dimension, identical in every backend."""
    idx: jnp.ndarray   # uint32 global sample index (scalar or per-lane)
    pix: jnp.ndarray   # uint32 per-pixel scramble base
    dim: int = 0

    def next_1f(self):
        d = self.dim
        if d >= N_DIMS:
            raise ValueError(
                f"QMC spawn stream exhausted ({N_DIMS} dims): the spawn "
                "path draws more uniforms than qmc.N_DIMS — extend "
                "_JOE_KUO with more direction numbers")
        bits = sobol_u32(self.idx, d)
        dim_off = np.uint32((d * int(_DIM_STEP)) & 0xFFFFFFFF)
        sd, _ = rngmod.rand_u32(self.pix + dim_off)
        bits = owen_scramble_u32(bits, sd)
        u = rngmod._u32_to_f32(bits) * rngmod._INV_U32
        return u, QmcStream(self.idx, self.pix, d + 1)


jax.tree_util.register_dataclass(
    QmcStream, data_fields=["idx", "pix"], meta_fields=["dim"])


def spawn_stream(base_seed, sample_index, px, py) -> QmcStream:
    """The QMC stream for one camera spawn.

    base_seed: the render's base seed (NOT the frame seed — the scramble
    must be sample-invariant). sample_index: global progressive sample
    number (scalar, or a per-lane i32 plane in the regenerative/wavefront
    kernels). px/py: integer pixel coords.
    """
    salt = jnp.asarray(base_seed, jnp.uint32) ^ _QMC_SALT
    pix, _ = rngmod.rand_u32(rngmod.seed_pixels(salt, px, py))
    idx = jnp.asarray(sample_index, jnp.int32).astype(jnp.uint32)
    return QmcStream(idx=idx, pix=pix, dim=0)
