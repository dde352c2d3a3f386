"""Edge-aware denoising: first-hit AOVs + an a-trous wavelet filter.

The reference has no denoiser (its convergence story is progressive
accumulation only, src/kernels/blit.wgsl:38); this is a tpurt extension
for fast previews and offline animation, where per-frame spp is small and
single-wavelength spectral noise dominates.

Design (array-first):
  * `render_aovs` shoots one deterministic center ray per pixel (no RNG)
    through the existing batched intersector — first-hit albedo, shading
    normal, and depth planes, one jit, static shapes.
  * `atrous_denoise` is the classic a-trous wavelet reconstruction
    (Dammertz et al. 2010, "Edge-Avoiding A-Trous Wavelet Transform for
    Fast Global Illumination Filtering"): `iterations` passes of a dilated
    5x5 B3-spline kernel whose taps are re-weighted by color, normal, and
    depth edge-stopping functions. Each pass is 25 statically-shifted
    whole-image multiply-adds — pure elementwise work that XLA fuses
    per tap; no gathers, no data-dependent shapes.
  * Radiance is demodulated by albedo before filtering and remodulated
    after, so texture/material detail survives aggressive smoothing and
    only irradiance is blurred.

Filtering happens in *linear* radiance space (before the tonemap), like
every production denoiser; `denoise_image` mirrors `render.resolve_image`
but inserts the filter between resolve and tonemap.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpurt import tonemap as tm
from tpurt.camera import Camera, generate_rays
from tpurt.config import RenderConfig
from tpurt.render import RenderState


class AOVs(NamedTuple):
    """First-hit feature planes (arbitrary output variables)."""
    albedo: jnp.ndarray   # (H, W, 3) material color at the first hit; 1 on miss
    normal: jnp.ndarray   # (H, W, 3) geometric normal at the first hit; 0 on miss
    depth: jnp.ndarray    # (H, W)    hit distance t; 0 on miss


@functools.partial(jax.jit, static_argnames=("cfg",))
def _render_aovs_jit(scene, cfg: RenderConfig, camera: Camera) -> AOVs:
    from tpurt.query import _trace_rays_jit
    W, H = cfg.width, cfg.height
    x = jnp.arange(W, dtype=jnp.float32)
    y = jnp.arange(H, dtype=jnp.float32)
    px, py = jnp.meshgrid(x, y)                       # (H, W)
    u = ((px + 0.5) / W).reshape(-1)
    v = ((py + 0.5) / H).reshape(-1)
    o, d = generate_rays(camera, u, v)
    hits = _trace_rays_jit(scene, cfg, o, d)
    # miss default differs from the query API's zeros: albedo 1 keeps
    # demodulation a no-op on background pixels
    albedo = jnp.where(hits.hit[:, None], hits.albedo, 1.0)
    return AOVs(albedo=albedo.reshape(H, W, 3),
                normal=hits.normal.reshape(H, W, 3),
                depth=jnp.where(hits.hit, hits.t, 0.0).reshape(H, W))


def render_aovs(scene, cfg: RenderConfig, camera: Camera) -> AOVs:
    """Deterministic feature pass: one un-jittered center ray per pixel.

    Camera rays only (the denoiser guides on primary-visibility features;
    secondary bounces are what the filter is smoothing). Dielectric
    first hits keep their material color as albedo — for the default
    near-white glass this makes demodulation a near-no-op there, which is
    the right behavior for a specular surface. A MotionCamera uses its
    shutter-open pose (features stay deterministic).
    """
    from tpurt.camera import base_camera
    return _render_aovs_jit(scene, cfg, base_camera(camera))


# 1D B3-spline kernel; the 5x5 filter is its outer product (separable, but
# edge weights break separability so the 25 taps are applied directly).
_B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def defocus_relax(cfg: RenderConfig, depth, clamp_px: float = 2.0):
    """Per-pixel feature-weight relaxation for depth-of-field renders.

    The AOV pass is pinhole (one center ray), so its normal/depth planes
    stay sharp where the lens has blurred the radiance — edge-stopping on
    them would wrongly preserve detail inside the blur. This computes the
    thin-lens circle of confusion in PIXELS at each first hit
    (ray-position error at depth z is (aperture/2)*|1 - z/F|, see
    camera.lens_perturb; divided by the pixel's world footprint z*|h|/W)
    and maps it to [0, 1]: 0 = in focus (full edge-stopping), 1 = blur
    radius >= clamp_px (features ignored, pure smoothing)."""
    if cfg.aperture <= 0.0:
        return jnp.zeros_like(depth)
    z = jnp.maximum(depth, 1e-3)
    coc_world = (0.5 * cfg.aperture) * jnp.abs(1.0 - z / cfg.focus_dist)
    # horizontal viewport spans 2*tan(vfov/2)*aspect at unit distance; use
    # the cfg aspect via width/height with a 60-degree-ish default scale —
    # the exact fov only rescales clamp_px, so derive from the camera-free
    # quantity: pixel footprint ~ z * (viewport/W). We take viewport ~ 1
    # per unit z, i.e. footprint = z / width; callers can tune clamp_px.
    px_size = z / jnp.float32(cfg.width)
    coc_px = coc_world / px_size
    relax = jnp.clip(coc_px / jnp.float32(clamp_px), 0.0, 1.0)
    return jnp.where(depth > 0, relax, 0.0)


@functools.partial(jax.jit, static_argnames=("iterations",))
def atrous_denoise(radiance, albedo, normal, depth, *, iterations: int = 5,
                   sigma_color: float | None = None,
                   sigma_normal: float = 0.35, sigma_depth: float = 0.1,
                   relax=None):
    """Edge-avoiding a-trous wavelet filter over (H, W, 3) linear radiance.

    Weights per tap q relative to center p (all Gaussian in squared
    feature distance):
      w_c = exp(-||c_p - c_q||^2 / sigma_c_i^2)   sigma_c_i = sigma_color/2^i
      w_n = exp(-||n_p - n_q||^2 / sigma_n^2)
      w_z = exp(-(z_p - z_q)^2 / (sigma_z * max(z_p, z_q, 1))^2)  (relative)
    The color sigma tightens each iteration (Dammertz sec. 4): early wide
    passes kill high-frequency noise, later dilated passes respect the
    partially-denoised signal. Radiance is demodulated by `albedo` before
    filtering and remodulated after.

    ``sigma_color=None`` (the default) estimates it from the input as
    2x the median neighbor-pair color distance of the demodulated
    radiance. This matters here more than in an RGB renderer: one
    wavelength per sample makes low-spp noise enormous in absolute terms
    (single-lambda CIE weights span hundreds of units), and any fixed
    sigma either erases edges at high spp or stops filtering entirely at
    low spp. The median tracks the actual noise floor, so the same call
    works across the whole progressive range.

    All shifts are static slices of an edge-padded plane; each iteration
    is 25 fused multiply-adds over the whole image.
    """
    H, W = depth.shape
    eps = jnp.float32(1e-3)
    alb = jnp.maximum(albedo, eps)
    img = radiance / alb

    if sigma_color is None:
        # Per-pixel noise-floor estimate. Spectral MC noise is spatially
        # heterogeneous (photon-lit glass is orders of magnitude noisier
        # than NEE-lit walls), so one global sigma under-filters the noisy
        # regions: their speckle reads as "edges". Robustness to TRUE
        # edges comes Kuwahara-style — take the MINIMUM over four 5x5
        # quadrant box-means of the neighbor color distance, offset
        # diagonally from the pixel: at a clean edge at least one quadrant
        # lies entirely on one side (small mean keeps sigma tight, edge
        # preserved); in dense speckle every quadrant is noisy (sigma
        # grows, speckle smooths).
        d = jnp.sqrt(jnp.sum((img[:, 1:] - img[:, :-1]) ** 2, axis=-1))
        d = jnp.pad(d, ((0, 0), (0, 1)), mode="edge")          # (H, W)

        def _box5(a):
            ap = jnp.pad(a, ((2, 2), (2, 2)), mode="edge")
            rows = sum(ap[k:k + H] for k in range(5)) / 5.0
            return sum(rows[:, k:k + W] for k in range(5)) / 5.0

        b = _box5(d)
        bp = jnp.pad(b, ((3, 3), (3, 3)), mode="edge")
        quad = jnp.minimum(
            jnp.minimum(bp[:H, :W], bp[:H, 6:6 + W]),
            jnp.minimum(bp[6:6 + H, :W], bp[6:6 + H, 6:6 + W]))
        med = jnp.median(d)
        # Two guards on the local boost:
        #  * FLOOR at the global median — locals may only RAISE sigma
        #    above the image-wide noise floor (extra smoothing where all
        #    four quadrants are speckled), never lower it;
        #  * GATE by global noise-to-signal — when the whole image is
        #    noise (median neighbor distance comparable to the mean
        #    radiance, the 1-4 spp single-lambda regime) per-pixel "noisy
        #    spots" are indistinguishable from structure and boosting
        #    erases real edges, so the boost fades to the plain global
        #    rule; once the floor is well below the signal (converged
        #    walls, speckled glass) the boost acts at full strength.
        #    Measured knee (Cornell): ratio 0.18 at 4 spp one-lambda
        #    (boost must be off), 0.05 at 16 spp hero4 (must be on) —
        #    linear ramp between 0.15 and 0.05.
        ratio = med / jnp.maximum(jnp.abs(img).mean(), 1e-12)
        gate = jnp.clip((0.15 - ratio) / 0.10, 0.0, 1.0)
        sigma_color = jnp.maximum(
            2.0 * jnp.maximum(med, quad * gate), jnp.float32(1e-2))

    # feature-weight relaxation (defocus_relax): 0 = full edge-stopping,
    # 1 = features ignored for this pixel (its radiance is lens-blurred,
    # so the pinhole AOV edges are not real image edges)
    keep = None if relax is None else (1.0 - relax)

    def _pad(a, r):
        pw = ((r, r), (r, r)) + ((0, 0),) * (a.ndim - 2)
        return jnp.pad(a, pw, mode="edge")

    for i in range(iterations):
        step = 1 << i
        r = 2 * step
        imgp = _pad(img, r)
        np_ = _pad(normal, r)
        zp_ = _pad(depth, r)
        s_c2 = jnp.asarray((sigma_color / (1 << i)) ** 2, jnp.float32)
        s_n2 = jnp.float32(sigma_normal ** 2)

        acc = jnp.zeros_like(img)
        wsum = jnp.zeros((H, W, 1), img.dtype)
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                oy, ox = r + dy * step, r + dx * step
                c_q = jax.lax.dynamic_slice(
                    imgp, (oy, ox, 0), (H, W, 3))
                n_q = jax.lax.dynamic_slice(
                    np_, (oy, ox, 0), (H, W, 3))
                z_q = jax.lax.dynamic_slice(zp_, (oy, ox), (H, W))

                dc2 = jnp.sum((img - c_q) ** 2, axis=-1)
                dn2 = jnp.sum((normal - n_q) ** 2, axis=-1)
                zscale = sigma_depth * jnp.maximum(
                    jnp.maximum(depth, z_q), 1.0)
                dz2 = ((depth - z_q) / zscale) ** 2
                feat = dn2 / s_n2 + dz2
                if keep is not None:
                    feat = feat * keep
                w = (_B3[dy + 2] * _B3[dx + 2]
                     * jnp.exp(-dc2 / s_c2 - feat))[..., None]
                acc = acc + w * c_q
                wsum = wsum + w
        img = acc / jnp.maximum(wsum, jnp.float32(1e-8))

    return img * alb


def denoise_image(scene, cfg: RenderConfig, camera: Camera,
                  state: RenderState, *, iterations: int = 5,
                  sigma_color: float | None = None,
                  sigma_normal: float = 0.35,
                  sigma_depth: float = 0.1, key=None, saturation=None,
                  aovs: AOVs | None = None, tonemap: bool = True,
                  defocus_clamp_px: float = 2.0):
    """Drop-in denoising variant of `render.resolve_image`: resolve the
    accumulated state to linear radiance, a-trous filter it guided by a
    deterministic AOV pass, then tonemap (ref blit semantics preserved:
    per-pixel sample-count divide, blit.wgsl:38, then key/saturation
    curve). Pass `aovs` to reuse features across frames of a static scene
    (e.g. the viewer re-renders them only on camera change)."""
    n = cfg.n_pixels
    avg = tm.resolve(state.rgb_sum[:n], state.n_samples[:n])
    avg = avg.reshape(cfg.height, cfg.width, 3)
    if aovs is None:
        aovs = render_aovs(scene, cfg, camera)
    # DOF renders: relax feature edge-stopping where the lens has blurred
    # the radiance (the pinhole AOVs stay sharp there — see defocus_relax)
    relax = (defocus_relax(cfg, aovs.depth, clamp_px=defocus_clamp_px)
             if cfg.aperture > 0.0 else None)
    den = atrous_denoise(avg, aovs.albedo, aovs.normal, aovs.depth,
                         iterations=iterations, sigma_color=sigma_color,
                         sigma_normal=sigma_normal, sigma_depth=sigma_depth,
                         relax=relax)
    if not tonemap:
        return den        # linear, for temporal blending (tpurt.temporal)
    key = cfg.tonemap_key if key is None else key
    saturation = cfg.tonemap_saturation if saturation is None else saturation
    return tm.tonemap(den, key, saturation)
