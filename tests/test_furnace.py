"""Furnace-style energy-conservation tests (SURVEY.md §4.3).

The reference has no environment emitter (sky is black, wgsl :617-620), so
the classic constant-radiance-enclosure furnace doesn't apply; the invariant
it checks — scatter routines neither create nor lose unaccounted energy —
is pinned directly at the BSDF sampling level instead: each importance-
sampled throughput multiplier f*cos/pdf must respect its analytic bound.

Runs the component-form (kernel) implementations on random inputs; the XLA
integrator shares the same formulas (cross-backend parity tests cover the
equivalence).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpurt.ops.scatter_c import (
    diffuse_scatter_c as _diffuse_scatter_c,
    scatter_dielectric_c as _scatter_dielectric_c,
    scatter_metal_c as _scatter_metal_c,
)
from tpurt.ops import soa as s


def _rand_dirs(rng, n):
    v = rng.normal(size=(3, n)).astype(np.float32)
    v /= np.linalg.norm(v, axis=0, keepdims=True)
    return tuple(jnp.asarray(c) for c in v)


def _rand_hemi(rng, n, normal):
    """Directions in the hemisphere of `normal` (as wo must be)."""
    d = _rand_dirs(rng, n)
    flip = s.vdot(d, normal) < 0.0
    return s.vwhere(flip, s.vneg(d), d)


N = 4096
RNG = np.random.default_rng(3)
U = lambda: jnp.asarray(RNG.uniform(0, 1, N).astype(np.float32))


class TestDiffuseFurnace:
    def test_lambertian_white_furnace_exact(self):
        """sigma=0 Oren-Nayar == Lambertian: f*cos/pdf == albedo exactly
        for EVERY sample (the cosine pdf cancels the cosine), so a white
        (albedo 1) surface is lossless — the white furnace condition."""
        n = _rand_dirs(RNG, N)
        wo = _rand_hemi(RNG, N, n)
        albedo = (jnp.ones(N), jnp.ones(N), jnp.ones(N))
        _, tpm = _diffuse_scatter_c(wo, n, albedo, jnp.zeros(N), U(), U())
        for c in range(3):
            np.testing.assert_allclose(np.asarray(tpm[c]), 1.0, atol=2e-5)

    def test_oren_nayar_matches_analytic_scale(self):
        """sigma>0: throughput == albedo * (A + B max(0,cos dphi) sin_a
        tan_b) exactly (wgsl :182-209; the cosine pdf cancels). NOTE the
        qualitative Oren-Nayar model is NOT energy-conserving at grazing
        (tan_b is unbounded) — the reference inherits that, so the furnace
        property pinned here is formula fidelity, not a <=1 bound."""
        n = _rand_dirs(RNG, N)
        wo = _rand_hemi(RNG, N, n)
        alb, sig = 0.8, 0.5
        albedo = (jnp.full(N, alb),) * 3
        wi, tpm = _diffuse_scatter_c(wo, n, albedo, jnp.full(N, sig),
                                     U(), U())
        nv = np.maximum(np.asarray(s.vdot(n, wo)), 0.0)
        nl = np.maximum(np.asarray(s.vdot(n, wi)), 0.0)
        sig2 = sig * sig
        A = 1.0 - 0.5 * sig2 / (sig2 + 0.33)
        B = 0.45 * sig2 / (sig2 + 0.09)
        sv = np.sqrt(np.maximum(0.0, 1.0 - nv * nv))
        sl = np.sqrt(np.maximum(0.0, 1.0 - nl * nl))
        # project out the clamped-cosine parts like the kernel does
        wo_t = np.asarray(wo) - np.asarray(n) * nv
        wi_t = np.asarray(wi) - np.asarray(n) * nl
        cphi = np.clip((wo_t * wi_t).sum(0)
                       / np.maximum(sv * sl, 1e-20), -1, 1)
        cphi = np.where((sv > 1e-6) & (sl > 1e-6), cphi, 1.0)
        tanb = np.minimum(sv, sl) / np.maximum(np.maximum(nv, nl), 1e-20)
        want = alb * (A + B * np.maximum(0.0, cphi)
                      * np.maximum(sv, sl) * tanb)
        want = np.where((nv >= 1e-6) & (nl >= 1e-6), want, 0.0)
        np.testing.assert_allclose(np.asarray(tpm[0]), want,
                                   rtol=2e-3, atol=2e-4)


class TestDielectricFurnace:
    def test_smooth_glass_lossless(self):
        """Smooth dielectric: the Fresnel-stochastic choice has weight 1 —
        reflect keeps throughput 1, transmit scales radiance by 1/eta'^2
        (wgsl :927-928), nothing else. Every sample must be one of the two."""
        n = _rand_dirs(RNG, N)
        wo = _rand_hemi(RNG, N, n)
        eta = jnp.full(N, 1.5)
        wi, tpm, off, valid = _scatter_dielectric_c(
            wo, n, eta, jnp.zeros(N), U(), U(), U(), camera_pdf=True)
        t = np.asarray(tpm)[np.asarray(valid)]
        ok_reflect = np.isclose(t, 1.0, atol=1e-5)
        # entering (1/eta^2) or exiting (eta^2) transmission scaling
        ok_enter = np.isclose(t, 1.0 / 1.5 ** 2, atol=1e-5)
        ok_exit = np.isclose(t, 1.5 ** 2, atol=1e-4)
        assert (ok_reflect | ok_enter | ok_exit).all()
        assert ok_reflect.any() and ok_enter.any()

    def test_rough_reflection_bounded(self):
        """GGX VNDF reflection weight F*G2/G1 <= 1 (F <= 1, G2 <= G1)."""
        n = _rand_dirs(RNG, N)
        wo = _rand_hemi(RNG, N, n)
        eta = jnp.full(N, 1.5)
        alpha = jnp.full(N, 0.3)
        # u_choice=0 forces the reflect branch for most Fresnel values
        wi, tpm, off, valid = _scatter_dielectric_c(
            wo, n, eta, alpha, U(), U(), jnp.zeros(N), camera_pdf=False)
        refl = np.asarray(s.vdot(wi, n) * s.vdot(wo, n)) > 0
        t = np.asarray(tpm)[np.asarray(valid) & refl]
        assert (t <= 1.0 + 1e-4).all()


class TestMetalFurnace:
    def test_conductor_bounded_by_f0(self):
        """Metal throughput F(cos)*G2/G1: <= 1 per channel, and a perfect
        mirror (alpha=0, F0=1) is exactly lossless."""
        n = _rand_dirs(RNG, N)
        wo = _rand_hemi(RNG, N, n)
        one = (jnp.ones(N),) * 3
        wi, tp, valid = _scatter_metal_c(wo, n, one, jnp.zeros(N), U(), U())
        t = np.asarray(s.vmax_comp(tp))[np.asarray(valid)]
        np.testing.assert_allclose(t, 1.0, atol=1e-5)
        gold = tuple(jnp.full(N, v) for v in (1.0, 0.71, 0.29))
        wi, tp, valid = _scatter_metal_c(wo, n, gold, jnp.full(N, 0.2),
                                         U(), U())
        v = np.asarray(valid)
        for c in range(3):
            assert (np.asarray(tp[c])[v] <= 1.0 + 1e-4).all()


def test_white_light_integrates_to_white():
    """SURVEY §4.3: uniform (equal-energy) wavelength sampling through the
    CIE pipeline converges to the equal-energy white point — the spectral
    accumulation neither tints nor loses energy. Monte-Carlo form of the
    test_spectra integral check, through the actual sampling path."""
    from tpurt.ops.spectra import VISIBLE_MIN, VISIBLE_RANGE, cie_to_rgb
    u = jnp.asarray(RNG.uniform(0, 1, 200_000).astype(np.float32))
    lam = jnp.float32(VISIBLE_MIN) + u * jnp.float32(VISIBLE_RANGE)
    rgb = np.asarray(cie_to_rgb(lam)).mean(axis=0) * VISIBLE_RANGE
    # equal-energy illuminant E through the same pipeline, integrated
    lam_grid = jnp.linspace(380.0, 780.0, 8001)
    want = np.asarray(cie_to_rgb(lam_grid)).mean(axis=0) * VISIBLE_RANGE
    np.testing.assert_allclose(rgb, want, rtol=0.02)
