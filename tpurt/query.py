"""Public ray-query API: batched closest-hit and occlusion queries.

The reference keeps its intersection routines private to the mega kernel
(ref: src/kernels/mega_kernel.wgsl:330-428 `intersect` / :505-566
`shadow_factor`); this exposes tpurt's batched intersector as a library
surface, so the tracer embeds in other pipelines (visibility baking,
light-map sampling, AO probes, sensor simulation) without going through
a camera or film.

Array-first: rays are SoA `(N, 3)` arrays, the whole batch intersects
under one jit (chunked `lax.fori_loop` primitive sweeps, one-hot
matmul material lookup — no per-ray control flow), and results
come back as a flat NamedTuple of `(N,)`/`(N, 3)` arrays. `N` is the
only shape axis; keep it static across calls to stay on the compiled
path. Geometry semantics are the renderer's exactly: unnormalized
directions are legal (t is in units of |d|, like the reference's camera
rays, wgsl :897), hit points are pulled back by the same 0.9999 factor,
and occlusion applies the same Fresnel-dielectric transparency rule the
render path uses for shadow rays (wgsl :505-566).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpurt.config import RenderConfig
from tpurt.integrate import _shadow, intersect_scene, material_lookup
from tpurt.ops.intersect import MISS


class RayHits(NamedTuple):
    """Closest-hit results for a ray batch (all arrays length N)."""
    hit: jnp.ndarray       # (N,)   bool, True where anything was hit
    t: jnp.ndarray         # (N,)   f32 hit distance in units of |d|; MISS sentinel where hit=False
    position: jnp.ndarray  # (N, 3) hit point (pulled back 0.9999 like the render path); 0 on miss
    normal: jnp.ndarray    # (N, 3) outward geometric normal; 0 on miss
    mat_id: jnp.ndarray    # (N,)   i32 material index; -1 on miss
    albedo: jnp.ndarray    # (N, 3) material color at the hit; 0 on miss
    mtype: jnp.ndarray     # (N,)   i32 material type (0 diffuse / 1 dielectric / 2 metal); -1 on miss


@functools.partial(jax.jit, static_argnames=("cfg",))
def _trace_rays_jit(scene, cfg: RenderConfig, o, d) -> RayHits:
    hit = intersect_scene(scene, cfg, o, d)
    found = hit["t"] < MISS
    color, _, _, mtype = material_lookup(scene, hit["mat"])
    return RayHits(
        hit=found,
        t=hit["t"],
        position=jnp.where(found[:, None], hit["loc"], 0.0),
        normal=jnp.where(found[:, None], hit["normal"], 0.0),
        mat_id=jnp.where(found, hit["mat"], -1),
        albedo=jnp.where(found[:, None], color, 0.0),
        mtype=jnp.where(found, mtype, -1),
    )


def trace_rays(scene, origins, directions,
               cfg: RenderConfig | None = None) -> RayHits:
    """Closest hit for each ray in the batch.

    ``origins``/``directions`` are (N, 3); directions need not be unit
    length (t comes back in units of |d|). Uses the same sweep/BVH
    dispatch as the XLA render path (``cfg.use_bvh``/chunk sizes) — pass
    a RenderConfig to tune, or omit it for the defaults.
    """
    if cfg is None:
        cfg = RenderConfig()
    o = jnp.asarray(origins, jnp.float32).reshape(-1, 3)
    d = jnp.asarray(directions, jnp.float32).reshape(-1, 3)
    return _trace_rays_jit(scene, cfg, o, d)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _occlusion_jit(scene, cfg: RenderConfig, o, d, t_max, lam):
    return _shadow(scene, cfg, o, d, t_max, lam)


@functools.partial(jax.jit, static_argnames=("cfg", "samples"))
def _light_probe_jit(scene, cfg: RenderConfig, pos, norm, samples, seed):
    from tpurt.integrate import sample_direct_lighting
    from tpurt.ops import rng as rngmod
    from tpurt.ops.spectra import sample_wavelength
    from tpurt.render import _frame_seed
    n = pos.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    zero = jnp.zeros((n,), jnp.int32)

    def body(k, acc):
        rng = rngmod.seed_pixels(_frame_seed(seed, k), idx, zero)
        u_lam, rng = rngmod.rand_1f(rng)
        lam = sample_wavelength(u_lam)
        direct, _ = sample_direct_lighting(scene, cfg, pos, norm, lam, rng)
        return acc + direct

    acc = jax.lax.fori_loop(0, samples, body, jnp.zeros((n, 3)))
    return acc / jnp.float32(samples)


def light_probe(scene, points, normals, samples: int = 16,
                cfg: RenderConfig | None = None, seed=0) -> jnp.ndarray:
    """Direct-lighting bake: the estimator's NEE term at arbitrary surface
    points — (N, 3) RGB reflected radiance of a UNIT-ALBEDO diffuse
    surface (multiply by your own albedo), Monte-Carlo-averaged over
    ``samples`` spectral NEE draws per point under one jit.

    Exactly the render path's direct-lighting rule (wgsl :568-615):
    same light sampling (``cfg.light_sample`` modes included), same
    Fresnel-dielectric shadow attenuation, same Oren-Nayar shading
    factor. Pairs with ``trace_rays`` (surface finding) and
    ``occlusion`` (AO) for camera-less light-map baking —
    examples/bake_ao.py.
    """
    if int(samples) < 1:
        raise ValueError("samples >= 1 required")
    if cfg is None:
        cfg = RenderConfig()
    pos = jnp.asarray(points, jnp.float32).reshape(-1, 3)
    nrm = jnp.asarray(normals, jnp.float32).reshape(-1, 3)
    return _light_probe_jit(scene, cfg, pos, nrm, int(samples),
                            jnp.asarray(seed, jnp.uint32))


def occlusion(scene, origins, directions, t_max,
              cfg: RenderConfig | None = None,
              lambda_nm=550.0) -> jnp.ndarray:
    """Transmittance along each segment ``origin + s*direction, s in
    (0, t_max)``: 0.0 fully blocked, 1.0 unobstructed.

    This is the render path's shadow rule exactly (wgsl :505-566):
    opaque geometry blocks, smooth dielectrics pass the squared Fresnel
    transmission at ``lambda_nm`` (scalar or (N,) — dispersive glass
    shadows are wavelength-dependent), rough dielectrics block.
    ``t_max`` is scalar or (N,), in units of |d| like trace_rays.
    """
    if cfg is None:
        cfg = RenderConfig()
    o = jnp.asarray(origins, jnp.float32).reshape(-1, 3)
    d = jnp.asarray(directions, jnp.float32).reshape(-1, 3)
    n = o.shape[0]
    t = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    lam = jnp.broadcast_to(jnp.asarray(lambda_nm, jnp.float32), (n,))
    return _occlusion_jit(scene, cfg, o, d, t, lam)
