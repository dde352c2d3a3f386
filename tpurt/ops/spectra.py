"""Spectral rendering support: CIE 1931 tables, Planck blackbody, Cauchy IOR.

Capability parity with the reference renderer's spectral machinery
(ref: src/spectrum.rs and src/kernels/mega_kernel.wgsl:95-164,434-458,260-263).
The CIE 1931 2-degree observer data (380-780nm, 5nm steps, 81 entries) is
standard public colorimetry data (same provenance as pbrt-v4).

Everything here is shape-polymorphic jnp: lambda arrays in, RGB arrays out,
so the identical code runs in the XLA path and inside Pallas kernels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

VISIBLE_MIN = 380.0
VISIBLE_MAX = 780.0
VISIBLE_RANGE = 400.0  # uniform-lambda pdf normalization = 1/range
N_CIE = 81
CIE_STEP = 5.0
DISPERSION_B = 0.004  # Cauchy B coefficient, um^2 (ref: mega_kernel.wgsl:100)

# CIE 1931 2-deg standard observer, 380..780nm @ 5nm (public data).
CIE_X = np.array([
    0.001368000, 0.002236000, 0.004243000, 0.007650000, 0.01431000,
    0.02319000, 0.04351000, 0.07763000, 0.1343800, 0.2147700,
    0.2839000, 0.3285000, 0.3482800, 0.3480600, 0.3362000,
    0.3187000, 0.2908000, 0.2511000, 0.1953600, 0.1421000,
    0.09564000, 0.05795001, 0.03201000, 0.01470000, 0.004900000,
    0.002400000, 0.009300000, 0.02910000, 0.06327000, 0.1096000,
    0.1655000, 0.2257499, 0.2904000, 0.3597000, 0.4334499,
    0.5120501, 0.5945000, 0.6784000, 0.7621000, 0.8425000,
    0.9163000, 0.9786000, 1.0263000, 1.0567000, 1.0622000,
    1.0456000, 1.0026000, 0.9384000, 0.8544499, 0.7514000,
    0.6424000, 0.5419000, 0.4479000, 0.3608000, 0.2835000,
    0.2187000, 0.1649000, 0.1212000, 0.08740000, 0.06360000,
    0.04677000, 0.03290000, 0.02270000, 0.01584000, 0.01135916,
    0.008110916, 0.005790346, 0.004109457, 0.002899327, 0.002049190,
    0.001439971, 0.0009999493, 0.0006900786, 0.0004760213, 0.0003323011,
    0.0002348261, 0.0001661505, 0.0001174130, 0.00008307527, 0.00005870652,
    0.00004150994,
], dtype=np.float32)

CIE_Y = np.array([
    0.00003900000, 0.00006400000, 0.0001200000, 0.0002170000, 0.0003960000,
    0.0006400000, 0.001210000, 0.002180000, 0.004000000, 0.007300000,
    0.01160000, 0.01684000, 0.02300000, 0.02980000, 0.03800000,
    0.04800000, 0.06000000, 0.07390000, 0.09098000, 0.1126000,
    0.1390200, 0.1693000, 0.2080200, 0.2586000, 0.3230000,
    0.4073000, 0.5030000, 0.6082000, 0.7100000, 0.7932000,
    0.8620000, 0.9148501, 0.9540000, 0.9803000, 0.9949501,
    1.0000000, 0.9950000, 0.9786000, 0.9520000, 0.9154000,
    0.8700000, 0.8163000, 0.7570000, 0.6949000, 0.6310000,
    0.5668000, 0.5030000, 0.4412000, 0.3810000, 0.3210000,
    0.2650000, 0.2170000, 0.1750000, 0.1382000, 0.1070000,
    0.08160000, 0.06100000, 0.04458000, 0.03200000, 0.02320000,
    0.01700000, 0.01192000, 0.008210000, 0.005723000, 0.004102000,
    0.002929000, 0.002091000, 0.001484000, 0.001047000, 0.0007400000,
    0.0005200000, 0.0003611000, 0.0002492000, 0.0001719000, 0.0001200000,
    0.00008480000, 0.00006000000, 0.00004240000, 0.00003000000, 0.00002120000,
    0.00001499000,
], dtype=np.float32)

CIE_Z = np.array([
    0.006450001, 0.01054999, 0.02005001, 0.03621000, 0.06785001,
    0.1102000, 0.2074000, 0.3713000, 0.6456000, 1.0390501,
    1.3856000, 1.6229600, 1.7470600, 1.7826000, 1.7721100,
    1.7441000, 1.6692000, 1.5281000, 1.2876400, 1.0419000,
    0.8129501, 0.6162000, 0.4651800, 0.3533000, 0.2720000,
    0.2123000, 0.1582000, 0.1117000, 0.07824999, 0.05725001,
    0.04216000, 0.02984000, 0.02030000, 0.01340000, 0.008749999,
    0.005749999, 0.003900000, 0.002749999, 0.002100000, 0.001800000,
    0.001650001, 0.001400000, 0.001100000, 0.0008000000, 0.0006000000,
    0.0003400000, 0.0002400000, 0.0001900000, 0.0001000000, 0.00004999999,
    0.00003000000, 0.00002000000, 0.00001000000, 0.0, 0.0,
    0.0, 0.0, 0.0, 0.0, 0.0,
    0.0, 0.0, 0.0, 0.0, 0.0,
    0.0, 0.0, 0.0, 0.0, 0.0,
    0.0, 0.0, 0.0, 0.0, 0.0,
    0.0, 0.0, 0.0, 0.0, 0.0,
    0.0,
], dtype=np.float32)

# XYZ -> linear sRGB (D65) (ref: spectrum.rs:260-264).
XYZ_TO_SRGB = np.array([
    [3.2404542, -1.5371385, -0.4985314],
    [-0.9692660, 1.8760108, 0.0415560],
    [0.0556434, -0.2040259, 1.0572252],
], dtype=np.float32)

# Precomputed per-wavelength sRGB response: (81, 3). Baking the matrix into
# the table turns the in-kernel conversion into one lerp per channel (no 3x3
# matmul per lane).
CIE_RGB_TABLE = np.stack([CIE_X, CIE_Y, CIE_Z], axis=-1) @ XYZ_TO_SRGB.T


def cie_to_rgb(lambda_nm, table=None):
    """Piecewise-linear CIE lookup -> linear sRGB response at wavelength(s).

    Semantics match the reference kernel (ref: mega_kernel.wgsl:444-458):
    index clamped to [0, 80], linear interpolation between 5nm samples.
    ``table`` lets a caller pass its own device-resident copy.
    Returns (..., 3) float32.
    """
    if table is None:
        table = jnp.asarray(CIE_RGB_TABLE)
    t = (lambda_nm - VISIBLE_MIN) / CIE_STEP
    # u32(t) in the reference clamps negatives to 0 (WGSL f32->u32), so the
    # fractional part is taken against the CLAMPED index
    i = jnp.maximum(t.astype(jnp.int32), 0)
    f = (t - i.astype(jnp.float32))[..., None]
    a = jnp.minimum(i, N_CIE - 1)
    b = jnp.minimum(i + 1, N_CIE - 1)
    # One-hot matmul instead of gather: (..., 81) @ (81, 3).
    oh_a = (a[..., None] == jnp.arange(N_CIE, dtype=jnp.int32)).astype(jnp.float32)
    oh_b = (b[..., None] == jnp.arange(N_CIE, dtype=jnp.int32)).astype(jnp.float32)
    # HIGHEST: a float32 matmul may otherwise run in TF32 (GPU) and round
    # the CIE values through the one-hot select
    va = jnp.matmul(oh_a, table, precision=jax.lax.Precision.HIGHEST)
    vb = jnp.matmul(oh_b, table, precision=jax.lax.Precision.HIGHEST)
    return va * (1.0 - f) + vb * f


def blackbody(lambda_nm, temp_k):
    """Planck spectral radiance, scaled by 1e-14 as in the reference
    (ref: mega_kernel.wgsl:434-442). Shape-broadcasting over both args."""
    h = 6.62607015e-34
    c = 2.99792458e8
    k = 1.380649e-23
    c1 = 2.0 * h * c * c
    c2 = h * c / k
    l = lambda_nm * jnp.float32(1e-9)
    return jnp.float32(c1) / (l ** 5 * (jnp.exp(jnp.float32(c2) / (l * temp_k)) - 1.0)) * jnp.float32(1e-14)


def cauchy_ior(base_ior, lambda_nm):
    """Cauchy dispersion: n(lambda) = n0 + B/lambda_um^2
    (ref: mega_kernel.wgsl:260-263)."""
    lambda_um = lambda_nm * jnp.float32(1e-3)
    return base_ior + jnp.float32(DISPERSION_B) / (lambda_um * lambda_um)


def sample_wavelength(u):
    """Uniform wavelength in [380, 780) nm from a U[0,1) sample
    (ref: mega_kernel.wgsl:995). pdf = 1/VISIBLE_RANGE; the 400x factor in
    light emission is this pdf's reciprocal."""
    return jnp.float32(VISIBLE_MIN) + u * jnp.float32(VISIBLE_RANGE)


def _cie_rgb_np(lam_nm):
    """NumPy mirror of cie_to_rgb (host-side, for table precomputation)."""
    t = (np.asarray(lam_nm, np.float64) - VISIBLE_MIN) / CIE_STEP
    i = np.clip(t.astype(np.int32), 0, N_CIE - 1)
    j = np.clip(i + 1, 0, N_CIE - 1)
    f = np.clip(t - i, 0.0, 1.0)[..., None]
    return CIE_RGB_TABLE[i] * (1.0 - f) + CIE_RGB_TABLE[j] * f


def _blackbody_np(lam_nm, temp_k):
    """NumPy mirror of blackbody (host-side)."""
    h, c, k = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    l = np.asarray(lam_nm, np.float64) * 1e-9
    c1, c2 = 2.0 * h * c * c, h * c / k
    return c1 / (l ** 5 * (np.exp(c2 / (l * temp_k)) - 1.0)) * 1e-14


def hero_emission_table(color, intensity, temp, c: int):
    """Host-precomputed table of the C-averaged spectral emission of one
    light: G(lam) = (1/C) sum_j color*intensity*range * spd(lam_j) *
    cie_rgb(lam_j), with lam_j the hero rotation of lam. G is PERIODIC
    with period range/C (the rotation set is shift-invariant), so it folds
    into one table over [VISIBLE_MIN, VISIBLE_MIN + range/C] — a single
    ~range/(5C)-segment lookup replaces C full CIE chains in the kernels.
    Returns (n_nodes, 3) float32; last node wraps to the first (periodic).
    Node spacing matches the CIE 5nm grid when C divides range/5, making
    the CIE part of the average exact (blackbody is lerped, error <1e-4)."""
    delta = VISIBLE_RANGE / c
    # 2.5nm nodes: the CIE part stays exactly representable (piecewise
    # linear at 5nm), the blackbody-product lerp error drops ~4x (<6e-4)
    n_seg = max(1, int(round(2.0 * delta / CIE_STEP)))
    lam0 = VISIBLE_MIN + np.arange(n_seg + 1) * (delta / n_seg)
    tab = np.zeros((n_seg + 1, 3), np.float64)
    base = np.asarray(color, np.float64) * intensity * VISIBLE_RANGE / c
    for j in range(c):
        # no wrap: lam0 + j*delta <= VISIBLE_MAX exactly, and the fold
        # boundary must carry em(780), not em(380) — G has a jump there
        # (the rotation set of 480- ends at 780-, the set of 480 restarts
        # at 380; both are represented: node 0 vs node n_seg)
        lj = lam0 + j * delta
        spd = _blackbody_np(lj, temp) if temp > 0.0 else np.ones_like(lj)
        tab += base[None, :] * spd[:, None] * _cie_rgb_np(lj)
    return tab.astype(np.float32)


def hero_emission_table_jnp(color, intensity, temp, c: int):
    """Traced-scene twin of hero_emission_table (the XLA paths jit with the
    scene as a dynamic pytree, so the table is built in-graph — a few
    hundred flops). Same node layout as the host version."""
    delta = VISIBLE_RANGE / c
    n_seg = max(1, int(round(2.0 * delta / CIE_STEP)))
    lam0 = jnp.float32(VISIBLE_MIN) \
        + jnp.arange(n_seg + 1, dtype=jnp.float32) * jnp.float32(delta / n_seg)
    base = color * intensity * jnp.float32(VISIBLE_RANGE / c)   # (3,)
    tab = jnp.zeros((n_seg + 1, 3), jnp.float32)
    for j in range(c):
        lj = lam0 + jnp.float32(j * delta)  # no wrap — see host twin
        spd = jnp.where(temp > 0.0, blackbody(lj, jnp.maximum(temp, 1.0)),
                        1.0)
        tab = tab + base[None, :] * spd[:, None] * cie_to_rgb(lj)
    return tab


def hero_emission_lookup(tab, c: int, lam):
    """Periodic lerp into a hero emission table (gather form, for the XLA
    paths; kernels use ops.soa.hero_em_lookup_c — same arithmetic).
    lam (N,) -> (N, 3)."""
    n_seg = tab.shape[0] - 1
    delta = VISIBLE_RANGE / c
    t = (lam - jnp.float32(VISIBLE_MIN)) / jnp.float32(delta)
    frac = t - jnp.floor(t)
    u = frac * jnp.float32(n_seg)
    i = jnp.clip(u.astype(jnp.int32), 0, n_seg - 1)
    f = (u - i.astype(jnp.float32))[:, None]
    tab = jnp.asarray(tab)
    return tab[i] * (1.0 - f) + tab[i + 1] * f
