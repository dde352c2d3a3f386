"""tpurt vs the reference-faithful scalar oracle (tests/wgsl_oracle.py).

THE fidelity test: the oracle transcribes the wgpu reference's estimator
per-pixel (ref: src/kernels/mega_kernel.wgsl:865-1021 + helpers) with its
exact single RNG stream — seeding :991, photon pass continuing the camera
stream :998-1015 — which tpurt deliberately replaces with per-phase
streams.  Both render the same scene with the same per-frame seed sequence
(tpurt's _frame_seed), so the camera jitter / wavelength draws coincide and
the residual difference is dominated by the decorrelated photon/path draws.
Comparison is per-pixel z-scores against the oracle's tracked variance of
the mean (both estimators carry noise, hence the 2x SE normalization) plus
a mean-image bound.  If tpurt's estimator drifts from the reference's in
ANY term (NEE weights, Fresnel shadow attenuation, photon kernel, RR, SPPM
radius schedule, CIE/blackbody scaling), these bounds trip.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tpurt import RenderConfig, default_scene, make_camera
from tpurt.render import _frame_seed, init_state, render
from tpurt.scene import Light, Material, Sphere, build_scene

from wgsl_oracle import Rng, render_oracle, scene_from_tpurt


def _seeds(base, n):
    return [int(_frame_seed(jnp.uint32(base), jnp.int32(k)))
            for k in range(n)]


def _render_tpurt(scene, cam, W, H, D, N, base_seed, **cfg_kw):
    cfg = RenderConfig(width=W, height=H, depth=D, tile_size=W * H, **cfg_kw)
    st = render(scene, cfg, cam, init_state(cfg), base_seed, N)
    return np.asarray(st.rgb_sum)[: W * H].reshape(H, W, 3) / N


def _compare(scene, cam, W, H, D, N, base_seed=1234, tail_frac=0.0,
             pool=1, mean_tol=0.02, **cfg_kw):
    """pool > 1: compare POOLED pool x pool cell means instead of raw
    pixels.  The z-score normalizes by the ORACLE's tracked SE only —
    tpurt's own estimator noise is unmodeled — and on caustic-heavy
    scenes (a lens / rough glass focusing a light) the per-pixel sampling
    distribution is so heavy-tailed that a rare bright path landing in
    one estimator's samples but not the other's throws z into the
    hundreds at perfectly healthy pixels.  Pooling averages each cell
    over pool^2 x N draws, restoring the CLT the z-test assumes;
    tail_frac then allows a small residual cell tail.  The original
    scenes keep pool=1/tail 0 (strict); drift is always still pinned by
    the 2% mean-image bound."""
    osc = scene_from_tpurt(scene)
    omean, ovar = render_oracle(osc, cam, W, H, D, _seeds(base_seed, N),
                                track_var=True)
    timg = _render_tpurt(scene, cam, W, H, D, N, base_seed, **cfg_kw)

    if pool > 1:
        Hp, Wp = (H // pool) * pool, (W // pool) * pool
        sh = (Hp // pool, pool, Wp // pool, pool, 3)
        om = omean[:Hp, :Wp].reshape(sh).mean((1, 3))
        tm = timg[:Hp, :Wp].reshape(sh).mean((1, 3))
        se = np.sqrt(ovar[:Hp, :Wp].reshape(sh).sum((1, 3))) / (pool * pool)
        z = np.abs(tm - om) / np.maximum(2.0 * se, 1e-3)
    else:
        se = np.sqrt(ovar)
        z = np.abs(timg - omean) / np.maximum(2.0 * se, 1e-3)
    assert (z > 5.0).mean() <= tail_frac, (
        f"{(z > 5.0).sum()} cells beyond 5 sigma "
        f"({(z > 5.0).mean():.2%} > allowed {tail_frac:.2%}, max z "
        f"{z.max():.1f}, pool {pool}) — estimator drift from the reference")
    rel = abs(timg.mean() - omean.mean()) / max(abs(omean.mean()), 1e-9)
    assert rel < mean_tol, (
        f"mean image off by {rel:.2%} (tol {mean_tol:.1%}) vs the "
        "reference oracle")
    return omean, ovar, timg


def test_default_scene_matches_reference():
    """The reference's own hard-coded scene (ref: lib.rs:220-447, minus the
    gitignored mesh): white ground, green diffuse, rough glass (GGX path),
    one 5500K square area light — camera lifted off the ground sphere (the
    reference camera starts ON it: near root t==0 culls every ground hit)."""
    scene = default_scene()
    cam = make_camera((0.0, 2.0, -6.0), (0.0, 1.0, 0.0), vfov=75.0,
                      aspect_ratio=16 / 9)
    omean, _, timg = _compare(scene, cam, 16, 9, 8, 250)
    assert omean.mean() > 0.05  # scene actually renders something


def test_point_light_smooth_glass_matches_reference():
    """Covers the branches the default scene misses: point-light NEE (no
    RNG draw, 1/d^2, ref :580-591), point-light photon cone emission
    (ref :753-756), and the effectively-smooth dielectric (alpha < 1e-3:
    stochastic Fresnel reflect/refract, ref :918-930)."""
    materials = [
        Material.diffuse((0.7, 0.7, 0.7)),
        Material.dielectric(1.5, 0.0),       # alpha = 0 -> smooth branch
        Material.diffuse((0.3, 0.5, 0.8)),
    ]
    spheres = [
        Sphere(0, 1000.0, (0.0, -1000.0, 0.0)),
        Sphere(1, 1.0, (0.0, 1.0, 0.0)),
        Sphere(2, 0.7, (2.0, 0.7, 1.0)),
    ]
    lights = [Light.point((0.0, 6.0, -2.0), (1.0, 0.9, 0.8), 40.0, 5500.0)]
    scene = build_scene(materials, spheres, [], lights)
    cam = make_camera((0.0, 2.0, -6.0), (0.0, 1.0, 0.0), vfov=70.0,
                      aspect_ratio=16 / 9)
    omean, _, timg = _compare(scene, cam, 16, 9, 8, 250, base_seed=777)
    assert omean.mean() > 0.05


def test_oracle_rng_bit_exact_vs_tpurt():
    """The oracle's scalar PCG must equal tpurt's vectorized rand_u32
    bit-for-bit (both transcribe mega_kernel.wgsl:655-660); this pins the
    oracle's stream to the implementation the unit suite already validates."""
    from tpurt.ops import rng as rngmod
    for seed in (0, 1, 1234, 0xDEADBEEF, 0xFFFFFFFF):
        r = Rng(seed)
        state = jnp.uint32(seed)
        for _ in range(16):
            want, state = rngmod.rand_u32(state)
            got = r.rand()
            assert int(want) == got, f"seed {seed}: {int(want)} != {got}"
            assert int(state) == r.state


def test_mesh_scene_matches_reference():
    """Triangle coverage of the fidelity contract: Moller-Trumbore
    closest hit (ref :303-338), sphere/mesh winner merge (:874-878,
    photon :768-770), and FULL triangle shadow occlusion (:540-562) —
    a lit quad over the ground sphere, where the quad both receives NEE
    and shadows the ground behind it."""
    from tpurt.scene import MeshData
    materials = [
        Material.diffuse((0.8, 0.8, 0.8)),
        Material.diffuse((0.85, 0.2, 0.2)),
    ]
    mesh = MeshData(material_id=1)
    quad_pos = np.array([[-1.5, 0.0, 2.0], [1.5, 0.0, 2.0],
                         [1.5, 2.5, 2.0], [-1.5, 2.5, 2.0]], np.float32)
    mesh.add_triangles(quad_pos, np.array([[0, 1, 2], [0, 2, 3]], np.int32))
    spheres = [Sphere(0, 1000.0, (0.0, -1000.0, 0.0))]
    lights = [Light.point((0.0, 4.0, -3.0), (1.0, 1.0, 0.9), 30.0, 5500.0)]
    scene = build_scene(materials, spheres, [mesh], lights)
    cam = make_camera((0.0, 1.5, -5.0), (0.0, 1.0, 0.0), vfov=70.0,
                      aspect_ratio=16 / 9)
    omean, _, timg = _compare(scene, cam, 16, 9, 6, 250, base_seed=555)
    assert omean.mean() > 0.03


def test_rough_ggx_photon_walk_matches_reference():
    """Rough-GGX-dominant scene (VERDICT r2 item 8a): a rough dielectric
    (alpha = sqrt(0.09) = 0.3, far above the 1e-3 smooth cutoff) dominates
    the frame, so both the CAMERA path (VNDF sample + reflect/transmit
    branches with their pdfs, ref :932-972) and the PHOTON walk (GGX
    scatter with Cauchy IOR, ref :795-852) run the rough branches almost
    every bounce, and the dielectric Fresnel SHADOW attenuation crosses
    the rough sphere (ref :511-538).

    Note on the photon-gather GGX estimator (ref :725-743, oracle
    evaluate_bsdf): its GGX branch is UNREACHABLE from any render in the
    reference — vispoints are stored only at diffuse hits
    (ref :889-900, `material_type == 0` branch), so the gather material
    is always Oren-Nayar. tpurt keeps the same store rule, so the live
    GGX photon physics is the walk scattering this scene exercises."""
    materials = [
        Material.diffuse((0.75, 0.75, 0.75)),
        Material.dielectric(1.5, 0.09),       # alpha = 0.3 -> rough branch
        Material.diffuse((0.7, 0.3, 0.2)),
    ]
    spheres = [
        Sphere(0, 1000.0, (0.0, -1000.0, 0.0)),
        Sphere(1, 1.3, (0.0, 1.3, 0.0)),      # rough glass fills the view
        Sphere(2, 0.6, (1.9, 0.6, 1.2)),
    ]
    lights = [Light.square_area((4.0, 5.0, -2.0), (-0.6, -1.0, 0.4), 1.5,
                                (1.0, 0.95, 0.9), 25.0, 5500.0)]
    scene = build_scene(materials, spheres, [], lights)
    cam = make_camera((0.0, 1.8, -4.5), (0.0, 1.0, 0.0), vfov=60.0,
                      aspect_ratio=16 / 9)
    # GGX glints are so rare and bright that no spatial pooling restores
    # the CLT (measured: 1.2% of pool-2 cells still trip on pure
    # fireflies while the MEAN image agrees to 0.02%), so this scene
    # trades a 2% cell tail for a 4x tighter integral bound.
    omean, _, timg = _compare(scene, cam, 32, 18, 8, 200, base_seed=4242,
                              pool=2, tail_frac=0.02, mean_tol=0.005)
    assert omean.mean() > 0.03


def test_camera_path_dispersion_quirk_pinned():
    """Pins the documented deviation flag (VERDICT r2 item 8b; SURVEY
    §2a): the reference's CAMERA path refracts with the BASE ior
    (ref :915) while photons/shadows use Cauchy (:797, :530) — the
    oracle transcribes that quirk. tpurt's default
    (dispersion_in_camera_path=False) must MATCH the oracle; setting it
    True (Cauchy on both paths, required for the dispersive benchmark)
    must produce a measurable difference where camera rays refract —
    asserting the deviation is exactly the documented one, not drift."""
    materials = [
        Material.diffuse((0.8, 0.8, 0.8)),
        Material.dielectric(1.5, 0.0),        # smooth: refract uses eta
    ]
    spheres = [
        Sphere(0, 1000.0, (0.0, -1000.0, 0.0)),
        Sphere(1, 1.4, (0.0, 1.4, 0.0)),      # big lens in front of camera
    ]
    lights = [Light.point((0.0, 7.0, 4.0), (1.0, 1.0, 1.0), 60.0, 5500.0)]
    scene = build_scene(materials, spheres, [], lights)
    cam = make_camera((0.0, 1.4, -3.4), (0.0, 1.2, 0.0), vfov=55.0,
                      aspect_ratio=16 / 9)
    W, H, D, N = 32, 18, 8, 200
    # default False == the reference quirk: full fidelity bound holds
    # (pooled: the lens focuses the point light into heavy-tailed
    # caustics, see _compare)
    omean, ovar, img_ref = _compare(scene, cam, W, H, D, N, base_seed=9090,
                                    pool=2, tail_frac=0.01, mean_tol=0.005)
    # True = Cauchy on the camera path too, SAME SEED: the two renders
    # share every RNG draw, so the images are coupled — a pixel's paths
    # are identical until their first glass refraction, where only eta
    # differs.  The documented deviation is therefore pinned EXACTLY:
    # pixels whose paths never met glass must be bit-identical, and a
    # substantial region (the lens and its caustics) must diverge.
    img_disp = _render_tpurt(scene, cam, W, H, D, N, 9090,
                             dispersion_in_camera_path=True)
    d = np.abs(img_disp - img_ref).max(axis=-1)     # (H, W) per pixel
    frac_changed = (d > 1e-4).mean()
    frac_identical = (d == 0.0).mean()
    assert 0.02 < frac_changed < 0.95, (
        f"dispersion_in_camera_path=True changed {frac_changed:.1%} of "
        "pixels — the deviation should be visible through the lens "
        "sphere but localized to glass-touching paths")
    assert frac_identical > 0.05, (
        f"only {frac_identical:.1%} of pixels bit-identical — the flag "
        "must change ONLY paths that refract through glass (same-seed "
        "coupling; photon/shadow Cauchy is identical in both renders)")

