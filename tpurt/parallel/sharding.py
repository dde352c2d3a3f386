"""Multi-chip scaling over a jax.sharding.Mesh.

The reference is strictly single-GPU (ref: src/lib.rs:148-163 — one device,
one queue; SURVEY.md §5 "distributed communication backend: ABSENT").  This
rebuild scales two embarrassingly-parallel axes instead, per SURVEY.md §5's
design decision:

  * pixel sharding  — each chip owns a contiguous slab of pixels and its
    slice of the accumulation / vispoint state; a frame needs zero
    communication (the scene is replicated), and only the final
    resolve/gather crosses the interconnect.
  * sample sharding — full image per chip, each chip advancing its own
    block of progressive samples, psum-reduced accumulators — for images
    too small to keep many chips busy (make_sample_sharded_step).

Pixel sharding is expressed with shard_map over a 1-D mesh built from
jax.devices() (every GPU of a host reaches every other at the same rate, so
the mesh follows the algorithm alone); XLA inserts the (trivial)
collectives.  Works identically on several GPUs and on the virtual CPU mesh
used by the tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpurt.config import RenderConfig
from tpurt.render import RenderState
from tpurt.runtime import pallas_interpret

AXIS = "px"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    return Mesh(np.array(devs[:n]), (AXIS,))


def padded_pixels_sharded(cfg: RenderConfig, n_dev: int) -> int:
    """Pixels padded so every device holds a whole number of tiles."""
    unit = cfg.tile_size * n_dev
    return ((cfg.n_pixels + unit - 1) // unit) * unit


def init_state_sharded(cfg: RenderConfig, mesh: Mesh) -> RenderState:
    """Like render.init_state but laid out over the mesh's pixel axis."""
    n_dev = mesh.devices.size
    Pn = padded_pixels_sharded(cfg, n_dev)
    sh1 = NamedSharding(mesh, P(AXIS))
    sh3 = NamedSharding(mesh, P(AXIS, None))
    rep = NamedSharding(mesh, P())
    z3 = jnp.zeros((Pn, 3), jnp.float32, device=sh3)
    return RenderState(
        rgb_sum=z3,
        n_samples=jnp.zeros((Pn,), jnp.float32, device=sh1),
        vis_pos=z3, vis_norm=z3, vis_wo=z3, vis_tp=z3,
        vis_mat=jnp.zeros((Pn,), jnp.int32, device=sh1),
        iteration=jnp.zeros((), jnp.int32, device=rep),
        photon_radius=jnp.asarray(cfg.photon_radius_init, jnp.float32, device=rep),
        rays=jnp.zeros((), jnp.float32, device=rep),
    )


# Partition specs for RenderState under pixel-slab sharding: per-pixel
# arrays split on the mesh axis, scalar counters replicated. ONE definition
# shared by every sharded step builder so layouts cannot drift.
_STATE_SPECS = RenderState(
    rgb_sum=P(AXIS, None), n_samples=P(AXIS),
    vis_pos=P(AXIS, None), vis_norm=P(AXIS, None),
    vis_wo=P(AXIS, None), vis_tp=P(AXIS, None), vis_mat=P(AXIS),
    iteration=P(), photon_radius=P(), rays=P(),
)


def _psum_rays(st: RenderState, rays0) -> RenderState:
    """Replace the per-device ray count accumulated since rays0 with its
    mesh-wide psum — the one collective in a sharded step."""
    import dataclasses as _dc
    return _dc.replace(st, rays=rays0 + jax.lax.psum(st.rays - rays0, AXIS))


def _local_step(scene, cfg, camera, state: RenderState, base_seed, depth,
                reduce_rays: bool = True):
    """Per-device body: render this device's pixel slab.

    Inside shard_map the state arrays are the local shard; pixel coordinates
    are reconstructed from the device's position on the mesh axis, so RNG
    streams stay globally consistent with the single-chip layout.  The step
    itself is render._step_body — the SAME code the single-chip renderer
    runs, so the two paths cannot drift.
    """
    from tpurt.render import _step_body

    me = jax.lax.axis_index(AXIS)
    Pl = state.rgb_sum.shape[0]  # local pixels
    gidx = me * Pl + jax.lax.broadcasted_iota(jnp.int32, (Pl, 1), 0)[:, 0]
    px = gidx % cfg.width
    py = jnp.minimum(gidx // cfg.width, cfg.height - 1)
    valid = gidx < cfg.n_pixels  # padding lanes never trace (exact counts)

    # reduce_rays=False: the caller's scan accumulates local counts and
    # psums ONCE after the loop (1 collective per call instead of spp)
    reduce = (lambda r: jax.lax.psum(r, AXIS)) if reduce_rays else None
    return _step_body(scene, cfg, camera, state, base_seed, depth,
                      px, py, valid, cfg.tile_size, rays_reduce=reduce)


def make_sharded_step(mesh: Mesh, cfg: RenderConfig, depth: int | None = None,
                      spp: int = 1):
    """Build the jitted multi-chip render step (spp samples per call).

    Returns f(scene, camera, state, base_seed) -> state. All state arrays are
    sharded over the pixel axis; scene/camera are replicated; the only
    collective per step is a scalar psum for the ray counter.
    """
    n_dev = mesh.devices.size
    d = cfg.depth if depth is None else depth

    def body(scene, camera, state, base_seed):
        rays0 = state.rays

        def one(st, _):
            return _local_step(scene, cfg, camera, st, base_seed, d,
                               reduce_rays=False), None
        st, _ = jax.lax.scan(one, state, None, length=spp)
        # one scalar psum per call: the scan accumulated local counts
        return _psum_rays(st, rays0)

    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), _STATE_SPECS, P()),
        out_specs=_STATE_SPECS,
        check_vma=False,
    )
    return jax.jit(sharded)


def make_sample_sharded_step(mesh: Mesh, cfg: RenderConfig, spp: int,
                             depth: int | None = None):
    """SAMPLE sharding (the data-parallel axis): every device renders the
    FULL image, device d advancing its own block of progressive samples
    [it0 + d*m, it0 + (d+1)*m) with m = spp/n_dev, then the accumulated
    radiance / sample-count / ray deltas are psum-reduced. For images too
    small to keep the mesh busy under pixel slabs (module header).

    Per-(pixel, sample) RNG streams are seeded by the GLOBAL iteration, so
    every camera path is the single-chip path; the SPPM radius schedule is
    advanced per device with radius_after (the same float sequence). One
    semantic caveat, documented rather than hidden: vispoint persistence
    (a camera path that stores no new vispoint keeps the previous
    sample's, ref mega_kernel.wgsl:897 / integrate.py trace_camera_paths)
    is blockwise — each device starts from the call's INPUT vispoints, not
    its predecessor device's finals. With photons enabled that means a
    block's early samples can deposit onto different (older) vispoints for
    pixels whose paths rarely hit diffuse surfaces, and since a photon
    lane is live only while its pixel HAS a vispoint (integrate.py vp_ok),
    photon segment counts differ slightly at block starts (~1% measured) —
    the same warmup the reference pays on its first frames. With
    cfg.enable_photons=False samples are fully independent: EXACT ray
    parity, image equal to single-chip up to float summation order. XLA
    integrator path (cfg.backend="xla").

    `state` must be the replicated full-image render.init_state(cfg).
    spp must be a multiple of the mesh size. Returns
    f(scene, camera, state, base_seed) -> state.
    """
    import dataclasses as _dc

    from tpurt.kernels.mega_regen import radius_after
    from tpurt.render import _render_step_impl

    n_dev = mesh.devices.size
    if spp % n_dev:
        raise ValueError(f"spp={spp} must be a multiple of the mesh size "
                         f"({n_dev}) for sample sharding")
    m = spp // n_dev
    d = cfg.depth if depth is None else depth
    rep_specs = RenderState(**{
        f.name: P() for f in _dc.fields(RenderState)})

    def body(scene, camera, state, base_seed):
        me = jax.lax.axis_index(AXIS)
        it0 = state.iteration
        st = _dc.replace(
            state,
            iteration=it0 + me * m,
            photon_radius=radius_after(cfg, it0, state.photon_radius,
                                       me * m))

        def one(s, _):
            return _render_step_impl(scene, cfg, camera, s, base_seed, d), None
        st, _ = jax.lax.scan(one, st, None, length=m)

        last = me == n_dev - 1

        def dsum(new, old):  # sum of per-device deltas on top of the input
            return old + jax.lax.psum(new - old, AXIS)

        def pick_last(x):  # the final device's value (zeros elsewhere)
            return jax.lax.psum(jnp.where(last, x, jnp.zeros_like(x)), AXIS)

        return RenderState(
            rgb_sum=dsum(st.rgb_sum, state.rgb_sum),
            n_samples=dsum(st.n_samples, state.n_samples),
            vis_pos=pick_last(st.vis_pos), vis_norm=pick_last(st.vis_norm),
            vis_wo=pick_last(st.vis_wo), vis_tp=pick_last(st.vis_tp),
            vis_mat=pick_last(st.vis_mat),
            iteration=it0 + spp,
            # the last device's final radius IS the full-schedule value
            photon_radius=pick_last(st.photon_radius),
            rays=dsum(st.rays, state.rays),
        )

    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), rep_specs, P()),
        out_specs=rep_specs,
        check_vma=False,
    )
    return jax.jit(sharded)


def make_wavefront_sharded_step(mesh: Mesh, cfg: RenderConfig, spp: int = 1):
    """Multi-chip WAVEFRONT step: each device drains an independent
    persistent ray pool (cfg.wf_pool slots per device) over its pixel slab.

    Pool occupancy is per-device, so path-length divergence never crosses
    the interconnect; the only collective per call is the scalar ray-count psum. Pixel
    ids inside each slab stay global for RNG/camera purposes
    (wavefront.wavefront_render_slab), so every (pixel, sample) path is the
    exact single-chip path — the image differs from the whole-image pool
    only by float splat order. Use with init_state_sharded; resolve with
    resolve_image_sharded. cfg.backend must be "wavefront".

    Returns f(scene, camera, state, base_seed) -> state.
    """
    if cfg.backend != "wavefront":
        raise ValueError(
            f"make_wavefront_sharded_step shards the XLA pool tracer "
            f"(cfg.backend='wavefront'), got backend={cfg.backend!r}")
    from tpurt.wavefront import reject_camera_strata, wavefront_render_slab
    reject_camera_strata(cfg)  # loud at build time, not first trace

    def body(scene, camera, state, base_seed):
        me = jax.lax.axis_index(AXIS)
        Pl = state.rgb_sum.shape[0]  # local slab rows
        offset = me * Pl
        n_valid = jnp.clip(jnp.int32(cfg.n_pixels) - offset, 0, Pl)
        rays0 = state.rays
        st = wavefront_render_slab(scene, cfg, camera, state, base_seed,
                                   jnp.int32(spp), offset, n_valid)
        return _psum_rays(st, rays0)

    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), _STATE_SPECS, P()),
        out_specs=_STATE_SPECS,
        check_vma=False,
    )
    return jax.jit(sharded)


def make_wavefront_budget_sharded_step(mesh: Mesh, cfg: RenderConfig,
                                       max_budget: int):
    """Multi-chip BUDGET wavefront step (adaptive sampling): each device
    drains its own persistent pool over its pixel slab's slice of a
    per-pixel budget map (tpurt.adaptive.wavefront_render_budget_slab).

    ``budgets`` is the full padded (P,) i32 map, sharded over the pixel
    axis like the state rows (pad rows 0). Every (pixel, sample) path is
    the exact single-chip path — only the float splat order differs from
    the whole-image pool. cfg.backend must be "wavefront".

    Returns f(scene, camera, state, base_seed, budgets) -> state.
    """
    if cfg.backend != "wavefront":
        raise ValueError(
            f"make_wavefront_budget_sharded_step shards the XLA pool "
            f"tracer (cfg.backend='wavefront'), got backend={cfg.backend!r}")
    from tpurt.adaptive import wavefront_render_budget_slab
    from tpurt.wavefront import reject_camera_strata
    reject_camera_strata(cfg)

    def body(scene, camera, state, base_seed, budgets):
        me = jax.lax.axis_index(AXIS)
        Pl = state.rgb_sum.shape[0]  # local slab rows
        offset = me * Pl
        rays0 = state.rays
        st = wavefront_render_budget_slab(scene, cfg, camera, state,
                                          base_seed, budgets, max_budget,
                                          offset)
        return _psum_rays(st, rays0)

    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), _STATE_SPECS, P(), P(AXIS)),
        out_specs=_STATE_SPECS,
        check_vma=False,
    )
    return jax.jit(sharded)


# ----- the fused kernel over the mesh -----

def padded_pixels_pallas(cfg: RenderConfig, n_dev: int) -> int:
    from tpurt.kernels.mega_pallas import block_grid
    g = block_grid(cfg)
    if g is not None:
        # whole (R x 128) image blocks, tile count rounded up so every
        # device gets an equal slab of tiles (extra tiles are all-padding)
        tiles = ((g[0] * g[1] + n_dev - 1) // n_dev) * n_dev
        return tiles * cfg.pallas_lanes
    unit = cfg.pallas_lanes * n_dev
    return ((cfg.n_pixels + unit - 1) // unit) * unit


def init_planes_sharded(cfg: RenderConfig, mesh: Mesh):
    """Zeroed (16, TR, 128) plane state sharded over the mesh's tile axis."""
    from tpurt.kernels.mega_pallas import N_CHANNELS
    n_dev = mesh.devices.size
    Pn = padded_pixels_pallas(cfg, n_dev)
    sh = NamedSharding(mesh, P(None, AXIS, None))
    return jnp.zeros((N_CHANNELS, Pn // 128, 128), jnp.float32, device=sh)


def make_regen_sharded_step(mesh: Mesh, cfg: RenderConfig, scene,
                            spp: int = 1):
    """Multi-chip REGENERATIVE megakernel step: each device runs the
    per-lane sample state machine on its pixel slab; tile_base keeps pixel
    ids / RNG streams global.

    Returns f(camera, planes, iteration, photon_radius, rays, base_seed) ->
    (planes, iteration, photon_radius, rays)."""
    from tpurt.kernels import mega_regen as mr

    mr.check_scene(scene, cfg)
    fscene = mr.freeze_scene(scene)
    interpret = pallas_interpret()
    R = cfg.pallas_lanes // 128

    def body(camera, planes, it, radius, rays, base_seed):
        me = jax.lax.axis_index(AXIS)
        tiles_local = planes.shape[1] // R
        new_planes, tile_rays = mr.regen_call(
            fscene, cfg, camera, planes, base_seed, jnp.int32(spp), it,
            radius, me * tiles_local, interpret)
        r_new = mr.radius_after(cfg, it, radius, jnp.int32(spp))
        return (new_planes, it + spp, r_new,
                rays + jax.lax.psum(jnp.sum(tile_rays), AXIS))

    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(None, AXIS, None), P(), P(), P(), P()),
        out_specs=(P(None, AXIS, None), P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def build_regen_budget_aux(cfg: RenderConfig, budgets, counts,
                           max_budget: int):
    """Aux planes for the sharded regen BUDGET step: the (3, TR, 128) f32
    stack of per-lane budget / base count / starting SPPM radius in plane
    order — the multi-chip twin of the single-chip packing inside
    mega_regen._render_budget_regen_jit (same clip, same radius
    recurrence, so sharded and single-chip runs stay bit-identical).
    ``budgets``/``counts`` are full padded (P,) arrays (budgets i32-like,
    counts = the state's per-pixel n_samples)."""
    from tpurt.kernels.mega_pallas import pixels_to_planes_order
    from tpurt.kernels.mega_regen import budget_radius_plane
    P_ = budgets.shape[0]
    budgets = jnp.clip(budgets.astype(jnp.int32), 0, max_budget)
    budgets = jnp.where(jnp.arange(P_) < cfg.n_pixels, budgets, 0)
    cnt_f = counts.astype(jnp.float32)
    rad0 = budget_radius_plane(cfg, cnt_f)
    aux = pixels_to_planes_order(
        cfg, jnp.stack([budgets.astype(jnp.float32), cnt_f, rad0]))
    return aux.reshape(3, P_ // 128, 128), budgets


def make_regen_budget_sharded_step(mesh: Mesh, cfg: RenderConfig, scene):
    """Multi-chip BUDGET regenerative step (adaptive sampling with the
    full estimator, sharded over pixel slabs): each device runs the
    per-lane budget state machine (mega_regen budget mode) on its plane
    slab; the aux budget/count/radius planes shard exactly like the state
    planes. Every (pixel, sample) path is the single-chip path.

    Returns f(camera, planes, aux, rays, base_seed) -> (planes, rays);
    build `aux` with build_regen_budget_aux (which owns the max_budget
    clip — the kernel reads per-lane budgets from the aux planes, so the
    step itself has no static budget bound, unlike the wavefront twin's
    round table) and track n_samples/iteration host-side like the
    single-chip render_budget_regen does.
    """
    from tpurt.kernels import mega_regen as mr

    mr.check_scene(scene, cfg)
    fscene = mr.freeze_scene(scene)
    interpret = pallas_interpret()
    R = cfg.pallas_lanes // 128

    def body(camera, planes, aux, rays, base_seed):
        me = jax.lax.axis_index(AXIS)
        tiles_local = planes.shape[1] // R
        new_planes, tile_rays = mr.regen_call(
            fscene, cfg, camera, planes, base_seed, 0, jnp.int32(0),
            jnp.float32(cfg.photon_radius_init), me * tiles_local,
            interpret, aux=aux)
        return (new_planes,
                rays + jax.lax.psum(jnp.sum(tile_rays), AXIS))

    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(None, AXIS, None), P(None, AXIS, None), P(), P()),
        out_specs=(P(None, AXIS, None), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def make_regen_sample_sharded_step(mesh: Mesh, cfg: RenderConfig, scene,
                                   spp: int):
    """SAMPLE sharding for the regenerative megakernel: the full plane
    state lives on every chip and device d advances its own block of
    progressive samples [it0 + d*m, it0 + (d+1)*m), m = spp/n_dev — the
    data-parallel axis of make_sample_sharded_step, on the fused kernel.
    Radiance channels (0-2, see mega_pallas.N_CHANNELS)
    psum their deltas; vispoint channels (3-15) take the final device's,
    with the same blockwise-persistence warmup caveat documented in
    make_sample_sharded_step (photon lanes need a vispoint to be live).

    Returns f(camera, planes, iteration, photon_radius, rays, base_seed) ->
    (planes, iteration, photon_radius, rays). planes is the REPLICATED
    full-image state from kernels.mega_pallas init layout (zeros of
    (N_CHANNELS, P/128, 128)); resolve with resolve_planes as usual.
    """
    from tpurt.kernels import mega_regen as mr

    mr.check_scene(scene, cfg)
    n_dev = mesh.devices.size
    if spp % n_dev:
        raise ValueError(f"spp={spp} must be a multiple of the mesh size "
                         f"({n_dev}) for sample sharding")
    m = spp // n_dev
    fscene = mr.freeze_scene(scene)
    interpret = pallas_interpret()

    def body(camera, planes, it, radius, rays, base_seed):
        me = jax.lax.axis_index(AXIS)
        it_d = it + me * m
        r_d = mr.radius_after(cfg, it, radius, me * m)
        new_planes, tile_rays = mr.regen_call(
            fscene, cfg, camera, planes, base_seed, jnp.int32(m), it_d,
            r_d, jnp.int32(0), interpret)
        last = (me == n_dev - 1)
        rgb = planes[:3] + jax.lax.psum(new_planes[:3] - planes[:3], AXIS)
        vis = jax.lax.psum(
            jnp.where(last, new_planes[3:], jnp.zeros_like(new_planes[3:])),
            AXIS)
        out = jnp.concatenate([rgb, vis], axis=0)
        r_new = mr.radius_after(cfg, it, radius, jnp.int32(spp))
        return (out, it + spp, r_new,
                rays + jax.lax.psum(jnp.sum(tile_rays), AXIS))

    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P()),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def render_image_sharded(scene, cfg: RenderConfig, camera, spp: int,
                         base_seed: int = 1234, mesh: Mesh | None = None,
                         axis: str = "auto"):
    """One-call multi-chip render: pick the sharding axis, run `spp`
    samples from a fresh state on the integrator cfg.backend names, and
    resolve to a host (H, W, 3) image.

    axis: "pixel" (each chip owns a slab of pixels), "sample" (full image
    per chip, per-device sample blocks), or "auto" — pixel slabs unless
    the image is too small to give every device one kernel tile of work
    (< pallas_lanes pixels per device on the fused kernel, < 4096 on
    XLA) and spp divides evenly over the mesh.

    cfg.backend "pallas" runs the regenerative megakernel (raising for
    scenes beyond its scope, like render()); "wavefront" runs one
    persistent pool per device (pixel axis only); "xla" the reference
    integrator. Returns (image, info) where info carries {"axis",
    "kernel", "rays", "iteration"}.
    """
    mesh = make_mesh() if mesh is None else mesh
    n_dev = mesh.devices.size
    seed = jnp.uint32(base_seed)
    use_pallas = cfg.backend == "pallas"

    if axis == "auto":
        per_dev = cfg.n_pixels // n_dev
        small = per_dev < (cfg.pallas_lanes if use_pallas else 4096)
        axis = "sample" if (small and spp % n_dev == 0
                            and cfg.backend != "wavefront") else "pixel"
    if axis not in ("pixel", "sample"):
        raise ValueError(f"axis must be pixel|sample|auto, got {axis!r}")

    if cfg.backend == "wavefront":
        if axis != "pixel":
            raise ValueError("the wavefront pool shards over pixels only")
        state = init_state_sharded(cfg, mesh)
        step = make_wavefront_sharded_step(mesh, cfg, spp=spp)
        state = step(scene, camera, state, seed)
        return resolve_image_sharded(cfg, state), {
            "axis": axis, "kernel": "wavefront", "rays": float(state.rays),
            "iteration": int(state.iteration)}

    if use_pallas:
        it0 = jnp.int32(0)
        r0 = jnp.float32(cfg.photon_radius_init)
        z = jnp.float32(0.0)
        if axis == "sample":
            from tpurt.kernels.mega_pallas import N_CHANNELS
            from tpurt.render import padded_pixels
            planes = jnp.zeros((N_CHANNELS, padded_pixels(cfg) // 128, 128),
                               jnp.float32)
            step = make_regen_sample_sharded_step(mesh, cfg, scene, spp=spp)
            kernel = "regen/sample"
        else:
            planes = init_planes_sharded(cfg, mesh)
            step = make_regen_sharded_step(mesh, cfg, scene, spp=spp)
            kernel = "regen/pixel"
        planes, it, radius, rays = step(camera, planes, it0, r0, z, seed)
        return resolve_planes(cfg, planes, int(it)), {
            "axis": axis, "kernel": kernel, "rays": float(rays),
            "iteration": int(it)}

    # XLA integrator (any scene size)
    from tpurt.render import init_state
    if axis == "sample":
        step = make_sample_sharded_step(mesh, cfg, spp=spp)
        state = step(scene, camera, init_state(cfg), seed)
        from tpurt.render import resolve_image
        img = np.asarray(resolve_image(cfg, state))
        kernel = "xla/sample"
    else:
        state = init_state_sharded(cfg, mesh)
        step = make_sharded_step(mesh, cfg, spp=spp)
        state = step(scene, camera, state, seed)
        img = resolve_image_sharded(cfg, state)
        kernel = "xla/pixel"
    return img, {"axis": axis, "kernel": kernel, "rays": float(state.rays),
                 "iteration": int(state.iteration)}


def planes_to_state(cfg: RenderConfig, planes, iteration, photon_radius,
                    rays) -> RenderState:
    """The fused kernel's (16, TR, 128) plane state (plane order, uniform
    sample count = iteration) as a RenderState in pixel order."""
    from tpurt.kernels.mega_pallas import N_CHANNELS, planes_pixel_order
    Pn = planes.shape[1] * 128
    flat = planes_pixel_order(cfg, planes.reshape(N_CHANNELS, Pn))

    def v3(a):
        return jnp.stack([flat[a], flat[a + 1], flat[a + 2]], axis=-1)
    return RenderState(
        rgb_sum=v3(0),
        n_samples=jnp.full((Pn,), iteration, jnp.float32),
        vis_pos=v3(3), vis_norm=v3(6), vis_wo=v3(9), vis_tp=v3(12),
        vis_mat=flat[15].astype(jnp.int32),
        iteration=jnp.asarray(iteration, jnp.int32),
        photon_radius=jnp.asarray(photon_radius, jnp.float32),
        rays=jnp.asarray(rays, jnp.float32))


def resolve_planes(cfg: RenderConfig, planes, iteration):
    """Resolve plane state to a host (H, W, 3) image: the pixel-order
    permutation, resolve and tonemap run on the device (XLA inserts the
    gather collective for sharded planes), then one transfer to the host."""
    from tpurt.render import resolve_image
    st = planes_to_state(cfg, planes, iteration, 0.0, 0.0)
    return np.asarray(resolve_image(cfg, st))


def resolve_image_sharded(cfg: RenderConfig, state: RenderState):
    """Gather + resolve the distributed accumulator to a host (H, W, 3)."""
    from tpurt import tonemap as tm
    rgb = np.asarray(jax.device_get(state.rgb_sum))[: cfg.n_pixels]
    ns = np.asarray(jax.device_get(state.n_samples))[: cfg.n_pixels]
    avg = rgb / np.maximum(ns, 1.0)[:, None]
    img = np.asarray(tm.tonemap(jnp.asarray(avg), cfg.tonemap_key, cfg.tonemap_saturation))
    return img.reshape(cfg.height, cfg.width, 3)
