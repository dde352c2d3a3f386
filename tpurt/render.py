"""Progressive renderer: the accelerator equivalent of the reference's
frame loop.

The reference accumulates radiance into an Rgba32Float texture (rgb = sum,
alpha = sample count, ref: mega_kernel.wgsl:1017-1021), keeps host-side
iteration / photon_radius counters (ref: mega_kernel.rs:24-25,191-198), and
clears on camera change.  Here all of that is one explicit pytree —
``RenderState`` — which makes checkpoint/resume trivial (the reference has no
persistence at all; ours falls out of the design, SURVEY.md §5).

Execution model: the image is split into fixed-size pixel tiles; one jitted
``render_step`` advances every tile by one progressive sample (1 spp + photon
pass), and ``render`` runs S steps under a single jit via lax.fori_loop —
zero host syncs between samples, matching the reference's fire-and-forget
frame submission (SURVEY.md §3.2).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpurt import tonemap as tm
from tpurt.camera import Camera
from tpurt.config import RenderConfig
from tpurt.integrate import render_tile
from tpurt.scene import Scene


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RenderState:
    """Everything that evolves across progressive samples. Arrays are flat
    (padded_n, ...) where padded_n rounds n_pixels up to a tile multiple."""
    rgb_sum: jnp.ndarray        # (P, 3) f32 — radiance sum (texture rgb)
    n_samples: jnp.ndarray      # (P,)   f32 — sample count (texture alpha)
    vis_pos: jnp.ndarray        # (P, 3) f32 — persistent vispoints
    vis_norm: jnp.ndarray       # (P, 3) f32
    vis_wo: jnp.ndarray         # (P, 3) f32
    vis_tp: jnp.ndarray         # (P, 3) f32
    vis_mat: jnp.ndarray        # (P,)   i32
    iteration: jnp.ndarray      # ()     i32
    photon_radius: jnp.ndarray  # ()     f32
    rays: jnp.ndarray           # ()     f32 — traced segments (metrics)


BACKENDS = ("xla", "pallas", "wavefront")


def padded_pixels(cfg: RenderConfig) -> int:
    n = cfg.n_pixels
    if cfg.backend == "pallas":
        # the fused kernel's tiles are (R x 128) image blocks (or, without
        # block tiles, runs of pallas_lanes linear pixels)
        from tpurt.kernels.mega_pallas import block_grid
        g = block_grid(cfg)
        if g is not None:
            return g[0] * g[1] * cfg.pallas_lanes
        t = cfg.pallas_lanes
    else:
        t = cfg.tile_size
    return ((n + t - 1) // t) * t


def init_state(cfg: RenderConfig) -> RenderState:
    """Fresh accumulation state — the analogue of clear_texture + counter
    reset (ref: lib.rs:514-526, mega_kernel.rs:224-243)."""
    P = padded_pixels(cfg)
    z3 = jnp.zeros((P, 3), jnp.float32)
    return RenderState(
        rgb_sum=z3, n_samples=jnp.zeros((P,), jnp.float32),
        vis_pos=z3, vis_norm=z3, vis_wo=z3, vis_tp=z3,
        vis_mat=jnp.zeros((P,), jnp.int32),
        iteration=jnp.zeros((), jnp.int32),
        photon_radius=jnp.asarray(cfg.photon_radius_init, jnp.float32),
        rays=jnp.zeros((), jnp.float32),
    )


def sppm_radius_step(cfg, k_f32, radius):
    """One SPPM radius update r *= sqrt((k + alpha)/(k + 1)) for the
    1-based sample index k (f32) — THE schedule formula, shared by every
    integrator path so the float sequence cannot drift
    (ref: mega_kernel.rs:196-198)."""
    return radius * jnp.sqrt((k_f32 + cfg.sppm_alpha) / (k_f32 + 1.0))


def _frame_seed(base_seed, iteration):
    """Per-frame seed sequence (reference draws rand::random() per frame,
    ref: mega_kernel.rs:191): decorrelate by hashing base ^ Weyl(iteration)."""
    from tpurt.ops.rng import rand_u32
    x = jnp.uint32(base_seed) + jnp.uint32(2654435761) * iteration.astype(jnp.uint32)
    out, _ = rand_u32(x)
    return out


def _pixel_coords(cfg: RenderConfig):
    P = padded_pixels(cfg)
    idx = np.arange(P, dtype=np.int32)
    px = idx % cfg.width
    py = np.minimum(idx // cfg.width, cfg.height - 1)  # clamp the pad tail
    return jnp.asarray(px), jnp.asarray(py)


def _check_camera_kind(cfg: RenderConfig, camera) -> None:
    """Catch the camera-type/flag mismatch (and bad cfg enums) up front —
    they would otherwise surface as an AttributeError deep inside a
    kernel trace (or silently fall back to reference behavior)."""
    from tpurt.camera import MotionCamera
    is_motion = isinstance(camera, MotionCamera)
    if cfg.motion_blur and not is_motion:
        raise TypeError("cfg.motion_blur=True needs a camera.MotionCamera "
                        "(shutter open/close pose pair), got a Camera")
    if is_motion and not cfg.motion_blur:
        raise TypeError("got a MotionCamera but cfg.motion_blur is False — "
                        "set RenderConfig(motion_blur=True) or pass "
                        "camera.cam0")
    if cfg.backend not in BACKENDS:
        raise ValueError(f"cfg.backend must be one of {BACKENDS}, got "
                         f"{cfg.backend!r}")
    if cfg.light_sample not in ("all", "power", "spatial"):
        raise ValueError(f"cfg.light_sample must be 'all', 'power' or "
                         f"'spatial', got {cfg.light_sample!r}")
    if not (0.0 < cfg.photon_rr_scale <= 1.0):
        # > 1 would bias photons DARKER, not lengthen walks: u_rr < 1 caps
        # effective survival at 1 while the reweight divides by prob*scale
        raise ValueError(f"cfg.photon_rr_scale must be in (0, 1], got "
                         f"{cfg.photon_rr_scale!r}")
    if not (0.0 <= cfg.photon_aim < 1.0):
        # q = 1 would drop the defensive cosine component of the emission
        # mixture and bias every contribution outside the aim cone to zero
        raise ValueError(f"cfg.photon_aim must be in [0, 1), got "
                         f"{cfg.photon_aim!r}")
    if cfg.photon_aim > 0.0 and not (cfg.photon_aim_widen > 0.0):
        # <= 0 would silently clamp to the AIM_SIN_MIN (1.1deg) cone inside
        # ops/soa.aimed_cone_c — reject it up front like the sibling knobs.
        # Only enforced when aiming is ON: with photon_aim=0 the widen
        # value is never read, and configs that always carried widen<=0
        # with aiming off rendered fine before this check existed.
        raise ValueError(f"cfg.photon_aim_widen must be > 0 when "
                         f"photon_aim > 0, got {cfg.photon_aim_widen!r}")
    if cfg.photon_aim > 0.0 and cfg.backend == "wavefront":
        raise NotImplementedError(
            "cfg.photon_aim is implemented in the XLA integrator and the "
            "regenerative megakernel only — use backend='xla' or "
            "backend='pallas'")


def render_step(scene: Scene, cfg: RenderConfig, camera: Camera,
                state: RenderState, base_seed, depth: int | None = None) -> RenderState:
    """Advance every pixel by one progressive sample (one reference frame).

    Dispatches on cfg.backend: the regenerative megakernel ("pallas"; it
    freezes the scene into compile-time constants, so `scene` must be
    concrete here — call this OUTSIDE any enclosing jit), the XLA pool
    wavefront ("wavefront") or the XLA integrator ("xla"). `depth`
    overrides cfg.depth (preview frames).
    """
    _check_camera_kind(cfg, camera)
    d = cfg.depth if depth is None else depth
    if cfg.backend == "wavefront":
        from tpurt.wavefront import wavefront_render
        # depth is a static constant of the pool tracer: a preview override
        # re-jits a depth-limited form
        return wavefront_render(scene, cfg.with_(depth=d), camera, state,
                                base_seed, 1)
    if cfg.backend == "pallas":
        from tpurt.kernels import mega_regen
        return mega_regen.render_regen(scene, cfg, camera, state, base_seed,
                                       1, depth=d)
    return _render_step_xla(scene, cfg, camera, state, base_seed, d)


@functools.partial(jax.jit, static_argnames=("cfg", "depth"))
def _render_step_xla(scene, cfg, camera, state, base_seed, depth: int):
    return _render_step_impl(scene, cfg, camera, state, base_seed, depth)


def _render_step_impl(scene, cfg, camera, state, base_seed, depth: int):
    px, py = _pixel_coords(cfg)
    T = cfg.tile_size
    P = padded_pixels(cfg)
    # padding lanes (pixel-count round-up) never trace: exact ray counts
    valid = (jnp.arange(P, dtype=jnp.int32) < cfg.n_pixels)
    return _step_body(scene, cfg, camera, state, base_seed, depth,
                      px, py, valid, T)


def _step_body(scene, cfg, camera, state, base_seed, depth: int,
               px, py, valid, T: int, rays_reduce=None):
    """ONE progressive XLA sample over the pixels (px, py) held in `state`
    — the single step body shared by the single-chip renderer and the
    shard_map per-device slab (parallel.sharding._local_step supplies
    mesh-local coordinates and a psum ray reduction)."""
    seed = _frame_seed(base_seed, state.iteration)
    strata_seed = None
    if cfg.photon_strata and cfg.photon_strata_window > 1:
        from tpurt.ops.rng import strata_epoch
        strata_seed = _frame_seed(base_seed,
                                  strata_epoch(cfg, state.iteration))
    P = state.rgb_sum.shape[0]
    n_tiles = P // T

    def tile_fn(args):
        tpx, tpy, tvalid, vis_prev = args
        color, vis, rays = render_tile(
            scene, cfg, camera, tpx, tpy, seed, state.photon_radius, depth,
            vis_prev, valid=tvalid, strata_seed=strata_seed,
            qmc_ctx=(base_seed, state.iteration) if cfg.qmc else None,
        )
        return color, vis, rays

    vis_prev = {
        "pos": state.vis_pos.reshape(n_tiles, T, 3),
        "norm": state.vis_norm.reshape(n_tiles, T, 3),
        "wo": state.vis_wo.reshape(n_tiles, T, 3),
        "tp": state.vis_tp.reshape(n_tiles, T, 3),
        "mat": state.vis_mat.reshape(n_tiles, T),
    }
    color, vis, rays = jax.lax.map(
        tile_fn, (px.reshape(n_tiles, T), py.reshape(n_tiles, T),
                  valid.reshape(n_tiles, T), vis_prev))

    it_new = state.iteration + 1
    r_new = sppm_radius_step(cfg, it_new.astype(jnp.float32),
                             state.photon_radius)
    total_rays = jnp.sum(rays)
    if rays_reduce is not None:
        total_rays = rays_reduce(total_rays)

    if cfg.radiance_clamp > 0.0:
        # per-sample firefly clamp (upper side only; see RenderConfig)
        color = jnp.minimum(color, jnp.float32(cfg.radiance_clamp))

    return RenderState(
        rgb_sum=state.rgb_sum + color.reshape(P, 3),
        n_samples=state.n_samples + 1.0,
        vis_pos=vis["pos"].reshape(P, 3),
        vis_norm=vis["norm"].reshape(P, 3),
        vis_wo=vis["wo"].reshape(P, 3),
        vis_tp=vis["tp"].reshape(P, 3),
        vis_mat=vis["mat"].reshape(P),
        iteration=it_new,
        photon_radius=r_new,
        rays=state.rays + total_rays,
    )


def render(scene: Scene, cfg: RenderConfig, camera: Camera,
           state: RenderState, base_seed, spp: int) -> RenderState:
    """Run `spp` progressive samples under ONE jit — no host round-trips.

    backend="pallas": the regenerative megakernel keeps its (16, TR, 128)
    planes resident for all spp samples (the (P,3)<->planes conversion is
    paid once per call) and raises for scenes beyond its scope.
    """
    _check_camera_kind(cfg, camera)
    if cfg.backend == "wavefront":
        from tpurt.wavefront import wavefront_render
        return wavefront_render(scene, cfg, camera, state, base_seed, spp)
    if cfg.backend == "pallas":
        from tpurt.kernels import mega_regen
        return mega_regen.render_regen(scene, cfg, camera, state, base_seed,
                                       spp)
    return _render_xla(scene, cfg, camera, state, base_seed, spp)


@functools.partial(jax.jit, static_argnames=("cfg", "spp"))
def _render_xla(scene, cfg, camera, state, base_seed, spp: int):
    def body(_, st):
        return _render_step_impl(scene, cfg, camera, st, base_seed, cfg.depth)
    return jax.lax.fori_loop(0, spp, body, state)


def render_until(scene: Scene, cfg: RenderConfig, camera: Camera,
                 state: RenderState, base_seed, *,
                 target_rel_err: float = 0.02, batch_spp: int = 8,
                 max_spp: int = 1024, min_batches: int = 2):
    """Progressive render until the image reaches a noise target
    (EXTENSION — the reference accumulates forever; this is the
    production stopping rule for offline/serving use).

    Renders ``batch_spp``-sample batches through ``render`` (any backend)
    and, after each, estimates the mean relative standard error of the
    accumulated image host-side from the BATCH means (Welford over the
    per-batch linear images — no extra device state, no estimator
    change):  err = mean(se_of_mean) / mean(|mean|), with the per-pixel
    standard error from the batch-to-batch sample variance over B
    batches. Stops when err <= target_rel_err (after at least
    ``min_batches`` batches, so the variance estimate exists) or when
    ``max_spp`` NEW samples have been added. SPPM note: photon batches
    are treated as i.i.d., which is conservative — the radius schedule
    makes later batches slightly LOWER variance.

    Returns ``(state, info)`` — info has spp (new samples added),
    batches, rel_err, and converged (whether the target was met).
    """
    if batch_spp < 1 or min_batches < 2:
        raise ValueError("batch_spp >= 1 and min_batches >= 2 required "
                         "(the batch variance divides by B-1)")
    n = cfg.n_pixels
    prev = np.asarray(state.rgb_sum, np.float64)[:n]
    # spp-weighted Welford over batch means: a truncated final batch
    # (max_spp not a multiple of batch_spp) has batch-mean variance
    # sigma^2/spp, so weighting by spp keeps `mean` equal to the true
    # accumulated mean and E[m2] = (B-1) * sigma^2 (per-SAMPLE variance).
    mean = np.zeros_like(prev)
    m2 = np.zeros_like(prev)
    done_spp, batches, rel_err = 0, 0, float("inf")
    while done_spp < max_spp:
        spp = min(batch_spp, max_spp - done_spp)
        state = render(scene, cfg, camera, state, base_seed, spp)
        done_spp += spp
        batches += 1
        cur = np.asarray(state.rgb_sum, np.float64)[:n]
        batch_mean = (cur - prev) / spp
        prev = cur
        delta = batch_mean - mean
        mean += delta * (spp / done_spp)
        m2 += spp * delta * (batch_mean - mean)
        if batches >= min_batches:
            sigma2 = m2 / (batches - 1)         # per-sample variance
            se = np.sqrt(sigma2 / done_spp)     # std error of accum mean
            rel_err = float(se.mean() / max(np.abs(mean).mean(), 1e-12))
            if rel_err <= target_rel_err:
                break
    return state, {"spp": done_spp, "batches": batches,
                   "rel_err": rel_err,
                   "converged": rel_err <= target_rel_err}


@functools.partial(jax.jit, static_argnames=("cfg",))
def resolve_image(cfg: RenderConfig, state: RenderState,
                  key=None, saturation=None):
    """Resolve + tonemap to an (H, W, 3) linear-RGB image (the blit pass,
    ref: blit.wgsl:36-41). Tonemap knobs are live-updatable like the
    reference's '='/'-'/'['/']' keys."""
    key = cfg.tonemap_key if key is None else key
    saturation = cfg.tonemap_saturation if saturation is None else saturation
    n = cfg.n_pixels
    avg = tm.resolve(state.rgb_sum[:n], state.n_samples[:n])
    img = tm.tonemap(avg, key, saturation)
    return img.reshape(cfg.height, cfg.width, 3)


@functools.partial(jax.jit, static_argnames=("cfg",))
def resolve_radiance(cfg: RenderConfig, state: RenderState):
    """Resolve to an (H, W, 3) HDR image of UNtonemapped mean spectral
    radiance (rgb_sum / n_samples — the blit's division, blit.wgsl:38,
    without its tonemap). Extension: the reference has no HDR export (its
    accumulation texture never leaves the GPU); this is the hook for EXR/PFM
    pipelines, light-probe captures, and post-processing outside the
    built-in Reinhard curve (pair with utils.image.write_pfm)."""
    n = cfg.n_pixels
    avg = tm.resolve(state.rgb_sum[:n], state.n_samples[:n])
    return avg.reshape(cfg.height, cfg.width, 3)


# ----- Checkpoint / resume (SURVEY.md §5: the accumulator IS the checkpoint) -----

def save_checkpoint(path: str, cfg: RenderConfig, state: RenderState) -> None:
    arrays = {f.name: np.asarray(getattr(state, f.name))
              for f in dataclasses.fields(RenderState)}
    np.savez_compressed(path, __cfg__=np.frombuffer(
        repr(dataclasses.asdict(cfg)).encode(), dtype=np.uint8), **arrays)


def load_checkpoint(path: str):
    """Returns (cfg, state). Accepts the path save_checkpoint was given
    even when np.savez appended the .npz suffix."""
    import ast
    import os
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    data = np.load(path)
    cfg_dict = ast.literal_eval(bytes(data["__cfg__"].tobytes()).decode())
    cfg = RenderConfig(**cfg_dict)
    kw = {f.name: jnp.asarray(data[f.name]) for f in dataclasses.fields(RenderState)}
    return cfg, RenderState(**kw)
