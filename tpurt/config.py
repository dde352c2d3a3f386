"""Render configuration.

The reference hard-codes all of these (ref: src/mega_kernel.rs:11-12 and
src/kernels/mega_kernel.wgsl:95-103); here they live in one frozen, hashable
dataclass used as a static jit argument, so every knob is compile-time
constant inside the kernels (no dynamic shapes, full unrolling freedom).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 1920
    height: int = 1080
    # Path tracing
    depth: int = 30                    # DEFAULT_DEPTH (ref: mega_kernel.rs:11)
    rr_threshold: float = 0.001        # camera-path RR kill (wgsl :977)
    # Photon / SPPM pass
    enable_photons: bool = True
    k_photons: int = 4                 # K_PHOTONS (wgsl :101)
    max_photon_bounces: int = 8        # MAX_PHOTON_BOUNCES (wgsl :102)
    photon_radius_init: float = 2.0    # PHOTON_RADIUS_INIT (mega_kernel.rs:12)
    photon_rr_threshold: float = 0.01  # photon RR kill (wgsl :856)
    photon_rr_scale: float = 1.0       # EXTENSION, in (0, 1] (1 = ref RR):
    #   thins the photon-walk Russian roulette — survival probability
    #   min(max_c(tp), 1) * scale, survivors reweighted by
    #   1/(max_c(tp) * scale). Composes with (not replaces) the
    #   reference's normalize-by-prob RR, so the per-bounce expectation
    #   equals the reference estimator's for every throughput; < 1 kills
    #   photons s-fold faster at every bounce, trading variance on deep
    #   photon contributions for fewer photon segments (the majority of
    #   all traced segments on photon-heavy scenes). Measure the trade
    #   with tools/quality.py --rr (var*rays at equal noise). Camera-path
    #   RR is untouched. At exactly 1.0 every kernel compiles to the
    #   reference's RR ops unchanged.
    photon_aim: float = 0.0            # EXTENSION, in [0, 1) (0 = reference
    #   sampling): importance-aimed photon emission from AREA lights. With
    #   probability q = photon_aim a photon's emission direction is drawn
    #   uniformly in a cone from its quad point toward the lane's own SPPM
    #   vispoint (half-angle subtending photon_aim_widen * photon_radius at
    #   the vispoint distance), otherwise from the reference's cosine
    #   hemisphere; the throughput is weighted by p_cos/p_mix (defensive
    #   mixture, ops/soa.aim_mixture_weight_c), which is unbiased for every
    #   integrand because the cosine component keeps full-hemisphere
    #   support (q < 1) and the vispoint/radius are data of the integral,
    #   not the photon's own draws. Lanes with no vispoint (and point
    #   lights, whose emission cone is already aimed, wgsl :710-721) use
    #   reference sampling with weight exactly 1. Dramatically raises the
    #   chance a FIRST photon segment lands inside the splat disc — the
    #   time-to-noise-target win is measured by tools/quality.py. Draws 3
    #   extra uniforms per photon spawn (after the reference layout, so
    #   flag-off streams are untouched). XLA + regenerative-megakernel
    #   backends only.
    photon_aim_widen: float = 3.0      # aim-cone padding over the splat
    #   disc: wider catches near-miss first hits that still scatter into
    #   the disc; narrower concentrates harder (clamped to [1.1deg, 45deg]
    #   half-angle either way, ops/soa.AIM_SIN_MIN/MAX).
    sppm_alpha: float = 0.67           # radius schedule (mega_kernel.rs:198)
    photon_strata: int = 0             # EXTENSION (0 = reference sampling):
    #   power-of-two N stratifies each photon's emission position and
    #   direction into a per-(sample, k) hash-chosen cell shared by ALL
    #   pixels — unbiased across samples, and the first photon segments of
    #   a tile become coherent enough for the culling votes to prune
    #   (ops/rng.emission_strata; docs/DESIGN.md)
    photon_strata_dir: int = 0         # direction-cell count when it should
    #   differ from photon_strata (0 = same). Direction dominates the beam
    #   footprint — a light tens of units away turns a coarse angular cell
    #   into a scene-wide beam — so n_dir typically wants 64-256 while
    #   position stays at 8-16.
    photon_strata_shared_k: bool = False  # ONE emission cell for all K
    #   photons of a sample (default: one cell per (sample, k)): the tile's
    #   whole photon phase becomes a single beam — the regenerative kernel
    #   interleaves different k across lanes, so per-k cells still mix K
    #   beams per tile. Unbiased; a sample's photons become correlated.
    photon_strata_bounce: bool = False  # extend the strata DEPTH-wise:
    #   remap each photon bounce's scatter uniforms (diffuse/GGX u2 +
    #   reflect/refract choice) into a tile-shared (sample, k, bounce)
    #   cell (ops/rng.apply_bounce_strata). A tight emission beam hits
    #   similar normals, so shared scatter cells keep segments 2+ coherent
    #   for the culling votes; per-lane RR still terminates independently.
    pallas_phase_split_votes: bool = False  # regen kernel: intersect with
    #   TWO phase-split culling votes (camera lanes, photon lanes) instead
    #   of one union vote. The regenerative kernel interleaves phases per
    #   lane, so a perfectly coherent photon beam still dragged incoherent
    #   camera lanes into every leaf vote (and vice versa); split votes
    #   let each phase prune like a pure tile. Bit-identical results (a
    #   leaf skipped for a phase is one no lane of that phase could be
    #   improved by); costs a second tree walk, so it wins only when the
    #   strata flags actually make each phase a beam.
    camera_strata_bounce: bool = False  # the camera-path analogue of
    #   photon_strata_bounce: diffuse/GGX scatter uniforms of camera
    #   bounce b remap into a tile-shared (sample, bounce) cell (key
    #   _CAMERA_STRATA_K, disjoint from every photon cell). Deep camera
    #   bounces — the residual incoherent tail once photon beams are
    #   stratified — sweep like the coherent primary phase. Unbiased
    #   across samples; within a sample the whole tile's bounce-b
    #   directions correlate (structured noise that averages out).
    photon_strata_window: int = 1      # power-of-two run of CONSECUTIVE
    #   samples sharing one cell epoch (stratum seed hashes the windowed
    #   global sample index). The regenerative kernel's lanes drift a few
    #   samples apart mid-render, so per-sample cells stop being
    #   tile-coherent; a window >= the drift re-aligns them. Unbiased
    #   (cells stay hash-uniform across epochs); convergence per sample
    #   slows as the window grows — window*K photons share each beam.
    #   Per-sample epochs (window=1) are lower-variance (QUALITY.json);
    #   bounding the drift at the source (pallas_regen_drift) is the
    #   other way to keep lanes on one epoch.
    # Spectral
    hero_wavelengths: int = 1          # 1 reproduces the reference (one
    #   lambda per sample, wgsl :995). >1 enables hero-wavelength sampling
    #   (Wilkie et al. 2014): C rotated wavelengths share each camera path,
    #   the NEE emission term averages their CIE responses, and a lane
    #   collapses to the hero's emission at FULL weight on its first
    #   dispersive (dielectric) camera interaction (the dirac continuation
    #   is hero-only, cf. pbrt-v4 TerminateSecondary). ~C x less spectral chroma noise on diffuse surfaces at
    #   near-zero extra cost (the rotation adds no RNG draws, so ray counts
    #   and cross-backend exactness are unchanged). Shadow attenuation
    #   through dielectrics is evaluated at the hero wavelength (documented
    #   deviation: the reference's straight-through Fresnel shadow term is
    #   itself an approximation).
    dispersion_in_camera_path: bool = False
    #   False reproduces the reference quirk (camera path uses the base IOR,
    #   wgsl :915, while photons/shadows use Cauchy). True applies Cauchy
    #   dispersion on the camera path too — required for the dispersive-glass
    #   benchmark config; documented deviation per SURVEY.md §2a.
    # Camera
    aperture: float = 0.0              # EXTENSION (0 = reference pinhole):
    #   thin-lens diameter in world units. >0 jitters each camera ray's
    #   origin over the lens disc and pivots it about the focal plane at
    #   focus_dist (camera.lens_perturb) — depth of field. Static: at 0
    #   the compiled kernels are bit-identical to the reference sampling
    #   (no extra draws); >0 inserts two lens uniforms after the pixel
    #   jitter in EVERY backend, so cross-backend exactness is preserved
    #   either way. The camera basis itself never changes (the reference
    #   consumes unnormalized ray directions, wgsl :897/:919, so a
    #   viewport rescale would perturb radiance).
    focus_dist: float = 1.0            # world distance (along the view
    #   axis) of the sharp plane when aperture > 0; ignored at aperture 0.
    light_sample: str = "all"          # EXTENSION ("all" = reference):
    #   NEE light strategy. "all" loops every light per bounce (shadow
    #   rays scale O(L), wgsl :568-615). "power" draws ONE light per
    #   bounce with probability proportional to intensity*(4*hw^2 | 1)
    #   and weights by 1/pmf (ops/sampling): O(1) shadow rays per bounce
    #   regardless of light count. "spatial" additionally divides each
    #   weight by the lane's squared distance to the light center (the
    #   unshadowed-contribution heuristic — use this one; "power" alone
    #   ignores proximity and costs variance when illumination is
    #   nearest-light dominated). Both are unbiased with the same draw
    #   layout in every backend (one select uniform + the 2f light
    #   sample), so cross-backend exactness holds. Photon emission is
    #   unchanged (already O(K), round-robin).
    qmc: bool = False                  # EXTENSION (False = reference):
    #   True draws the CAMERA-SPAWN uniforms (pixel jitter, shutter time,
    #   lens disc, wavelength) from a per-pixel Owen-scrambled Sobol
    #   sequence indexed by the global sample number (ops/qmc.py) instead
    #   of the PCG stream; all path/photon/NEE/RR draws keep the
    #   unchanged PCG streams. Low-discrepancy spawn points cover the
    #   pixel footprint / lens / shutter / spectrum evenly across
    #   samples: antialiasing, depth of field, motion blur and single-λ
    #   spectral noise converge up to O(N^-1.5). Unbiased (each draw is
    #   marginally uniform); spawn values are a pure function of
    #   (base_seed, pixel, sample, dim), so cross-backend exactness
    #   holds exactly as in PCG mode.
    motion_blur: bool = False          # EXTENSION (False = reference):
    #   True makes every backend accept a camera.MotionCamera (shutter
    #   open/close pose pair) and draw one shutter time per camera ray
    #   (after the pixel jitter, before the lens/wavelength draws — the
    #   same stream position everywhere, so cross-backend exactness
    #   holds). Camera-only blur; geometry is static. False compiles to
    #   the unchanged reference sampling.
    # Geometry path
    use_bvh: bool = False              # True: per-ray BVH traversal for
    #   closest-hit triangles (XLA path only; shadow rays and spheres stay
    #   brute force)
    # Execution shape
    backend: str = "xla"               # "xla" (the reference integrator) |
    #   "pallas" (the regenerative megakernel, kernels/mega_regen.py;
    #   sphere + small-mesh scenes, raises on larger ones) | "wavefront"
    #   (the XLA pool tracer, camera path + NEE only — BASELINE config 5)
    tile_size: int = 16384             # pixels per tile in the XLA path
    pallas_lanes: int = 256            # pixels per fused-kernel tile:
    #   128 x a power of two (R = lanes/128 rows of 128), at most 512 on a
    #   GPU. One program per tile, lanes/16 warps (two threads per lane);
    #   see PERF.md for the tile x warps sweep behind both.
    pallas_regen_drift: int = 0        # bound on how many samples a regen
    #   lane may run AHEAD of its tile's slowest lane (0 = unbounded).
    #   Lanes drift apart within a render call (path lengths vary), so by
    #   late samples a tile's live lanes span many sample indices — many
    #   distinct photon-strata beams — and the culling votes stop pruning.
    #   A bound of W caps the live-epoch spread at W at an occupancy cost:
    #   a lane at the bound idles until the tile minimum advances.
    #   SCHEDULING only — the traced samples, streams, and sums are
    #   bit-identical. Loose bounds capture little of the coherence:
    #   bound tightly or not at all.
    pallas_regen_drift_cam: int = 0    # CAMERA-spawn drift bound (0 = use
    #   pallas_regen_drift): with drift_cam > drift, a lane done with
    #   photons of sample s may start camera(s+1..s+drift_cam) early —
    #   primary rays are pixel-coherent regardless of strata epoch — while
    #   PHOTON-phase entry stays gated at the tight bound (spawn_p holds at
    #   k==0 until the tile minimum catches up). The per-lane sequence
    #   camera(s) -> photons(s) is unchanged, so results stay
    #   bit-identical; this only overlaps one lane's camera path with other
    #   lanes' photon walks.
    pallas_static_unroll: int = 32     # primitives baked into the
    #   instruction stream up to this count (constant-folded; compile time
    #   grows with the count). Above it: a device-memory table sweep (a
    #   fori_loop; compile time independent of the count).
    pallas_block_tiles: bool = True    # map each fused-kernel tile to an
    #   (R x 128)-pixel image BLOCK instead of `lanes` consecutive linear
    #   pixels. A block subtends a narrower frustum than a slab of a 1080p
    #   row, so tile-level votes (cluster culling, early loop exit) prune
    #   more. The pixel<->plane order permutation is paid once per render
    #   call in XLA (reshape/transpose), never in the kernel.
    pallas_cluster_size: int = 16      # two-level culling in the
    #   static-unroll mode: primitives are median-split into spatial groups
    #   of this size, and each group's unrolled sweep is gated by a
    #   whole-tile lax.cond on its AABB slab test (any active lane hits the
    #   box AND is still closer than its current best). Tile-coherent rays
    #   skip most groups. 0 disables (flat sweep). Only engages above 4x
    #   this count.
    sphere_chunk: int = 512            # primitive chunk sizes for the XLA
    tri_chunk: int = 256               # sweeps (ops/intersect.py)
    # Wavefront tracer (tpurt.wavefront; ref: src/wavefront.rs finished form)
    wf_pool: int = 262144              # persistent ray-pool capacity Q
    wf_max_sweeps: int = 100000        # safety bound on the sweep loop
    sky_gradient: bool = False         # legacy wavefront sky (wavefront.wgsl
    #   :129-131); False = black sky like the mega kernel (:617-620)
    # Environment emission (EXTENSION — the reference's sky returns black,
    # mega_kernel.wgsl:617-620). sky_intensity > 0 turns the miss branch of
    # EVERY backend's camera path into a spectral emitter with the same
    # form as the lights (color * intensity * blackbody(lambda, temp) *
    # cie_to_rgb(lambda) * range, wgsl :574-578): hero-averaged when
    # hero_wavelengths > 1, full-weight single-lambda after a dispersive
    # collapse. sky_temp = 0 means a flat (equal-energy) spectrum; with
    # sky_gradient also set the tint lerps white -> (.5,.7,1) by direction
    # (the legacy RGB gradient stays as-is when sky_intensity == 0).
    # Photons are unaffected (an environment emits, it does not receive).
    # No extra RNG draws or segments: cross-backend ray-count exactness
    # holds with the sky on.
    sky_intensity: float = 0.0
    sky_color: tuple = (1.0, 1.0, 1.0)
    sky_temp: float = 0.0
    # Robustness
    radiance_clamp: float = 0.0        # EXTENSION (0 = off, the reference):
    #   >0 clamps each SAMPLE's RGB radiance channelwise (upper side only —
    #   single-wavelength samples are legitimately negative in RGB) before
    #   it is accumulated, in every backend at the same point of the
    #   estimator, so cross-backend parity holds with the clamp on.
    #   Biased firefly control for low-spp/denoised/preview pipelines;
    #   leave 0 for converged or benchmark renders.
    # Instrumentation
    count_rays: bool = True            # accumulate traced-segment counter
    # Tonemap defaults (ref: blit.rs:99-101)
    tonemap_key: float = 0.8
    tonemap_saturation: float = 1.0

    def with_(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    # Measured flag stacks (rationale + numbers in docs/DESIGN.md). All
    # scene-independent and unbiased; scene-tuned stacks (photon strata
    # windows, BVH knobs) stay per-scene — see bench.py for those.
    PRESETS = {
        # pure reference parity: every extension off (== RenderConfig())
        "reference": {},
        # lowest variance per sample: hero-wavelength spectral sampling
        # (collapses single-lambda chroma noise, eff 10^3-10^5 on spectral
        # scenes) + Owen-scrambled Sobol camera spawn
        "quality": dict(hero_wavelengths=4, qmc=True),
        # fewest traced segments to a given noise floor: quality +
        # photon-walk RR thinning (32% fewer segments at unchanged
        # variance on NEE-lit scenes)
        "fast": dict(hero_wavelengths=4, qmc=True, photon_rr_scale=0.5),
        # the walk-scene stack (meshes and many-sphere instancing):
        # tile-coherent stratified photon emission + per-sample beam
        # epochs + the tight drift bound. Unbiased; QUALITY.json holds
        # its variance at equal spp.
        "walk": dict(photon_strata=16, photon_strata_dir=4096,
                     photon_strata_shared_k=True, photon_strata_bounce=True,
                     camera_strata_bounce=True, photon_strata_window=1,
                     pallas_regen_drift=1, hero_wavelengths=4),
    }

    @classmethod
    def preset(cls, name: str, **overrides) -> "RenderConfig":
        """A RenderConfig from a named, measured flag stack — the three
        above — with any field overridable: RenderConfig.preset("quality",
        width=1920, height=1080). Unknown names raise with the list."""
        if name not in cls.PRESETS:
            raise ValueError(f"unknown preset {name!r}; "
                             f"available: {sorted(cls.PRESETS)}")
        return cls(**{**cls.PRESETS[name], **overrides})

    @staticmethod
    def parse_overrides(pairs) -> dict:
        """CLI `--set KEY=VAL` pairs -> a validated kwargs dict (values via
        ast.literal_eval; unknown field names raise). Shared by viewer.py,
        tools/animate.py and tools/probe.py so every config knob is
        reachable from every entry point."""
        import ast
        fields = {f.name for f in dataclasses.fields(RenderConfig)}
        out = {}
        for kv in pairs or ():
            k, _, v = kv.partition("=")
            if k not in fields:
                raise SystemExit(
                    f"--set {k}: not a RenderConfig field "
                    f"(see tpurt/config.py for the list)")
            try:
                out[k] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                out[k] = v  # bare strings (e.g. backend=pallas)
        return out

    @property
    def n_pixels(self) -> int:
        return self.width * self.height
