"""Chip smoke test: tpurt's main path, once, on an NVIDIA GPU.

    python chip_smoke.py            # one GPU: the three phases below
    python chip_smoke.py --four     # four GPUs: the sharded steps only

One GPU. Each phase prints its compile time, its render time and
`compiled.memory_analysis()` of the jitted step it runs:
  1. xla     bench config 1 — Cornell spheres, 1920x1080, depth 30, photon
             pass on, reference sampler — for SPP samples through
             tpurt.render(backend="xla"); the image must be finite and the
             segment count positive.
  2. kernel  the same render on the regenerative megakernel
             (backend="pallas", compiled through Pallas' Triton route),
             compared with phase 1: segment counts, median |d rgb_sum|,
             share of pixels differing by more than 1e-2 (TOL below).
  3. golden  the 64x32 8-spp Cornell render against
             tests/golden/cornell_64x32_s1234_8spp.npz with the bounds of
             tests/test_golden.py (exact segment count).

--four runs each sharded step of tpurt.parallel on four GPUs and compares it
with the same render on one GPU (segment counts and images within TOL):
the pixel and sample steps on phase 1's render, the triangle-sharded
geometry steps on bench config 6's 4,050-triangle torus at GEO_SIZE.

The card's `nvidia-smi` name and power limit come first; the last line of
standard output is one JSON object {"ok": true, "device": {...}}. Any failed
phase, or a first device that is not a GPU, exits non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SPP = 4
# kernel vs XLA integrator at 1080p: relative segment-count difference,
# median |d rgb_sum| per channel, share of pixels with max |d| > 1e-2.
# Observed on an H100: 0 or 1.1e-7, 1.9e-6, 0.33% (both sides float32 with
# HIGHEST matmuls; reassociation flips rare near-threshold branches). The
# segment counter is a float32 sum: at 1080p x 4 spp (1.4e8 segments) one
# ulp is 16 segments, 1.1e-7, and summing in another order (other tiles,
# a psum over devices) may land one ulp away: counts are compared to
# 1e-6, not exactly.
TOL = {"rays_rel": 1e-6, "median_abs": 2e-5, "frac_gt_1e-2": 0.01}
# tests/test_golden.py's bounds, but for the share of differing pixels:
# the capture was made on the CPU, and ulp-level differences of the GPU's
# arithmetic (FMA contraction, its sin/cos/exp/log) flip near-threshold
# branches (RR, hit tests) in a few percent of pixels over 8 spp. Observed
# on an H100: XLA 2.34%, the Triton kernel 2.44%, the two against each
# other 0.63%, XLA with every matmul forced to HIGHEST bit-identical to
# the default (no TF32 anywhere); on the CPU the interpreted kernel, whose
# only difference is the order of operations, 1.7%. The segment count
# still has to match exactly.
GOLDEN_TOL = {"median_abs": 1e-4, "frac_gt_1e-2": 0.05, "radius_rtol": 1e-6}
# --four's geometry steps: the XLA integrator's per-ray BVH takes ~3.3 s
# per 16384-pixel tile and sample of the 4,050-triangle torus on an H100
# (~28 min for a 1080p 4-spp reference), so they run at 480x270, 1 spp.
GEO_SIZE, GEO_SPP = (480, 270), 1


def log(*a):
    print(*a, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def cornell(width, height, depth=30, **kw):
    from tpurt import RenderConfig, cornell_spheres_scene, make_camera
    cfg = RenderConfig(width=width, height=height, depth=depth, **kw)
    cam = make_camera((0, 5, -12), (0, 5, 0), vfov=60.0,
                      aspect_ratio=width / height)
    return cfg, cornell_spheres_scene(), cam


def compile_step(scene, cfg, cam, state, seed, spp):
    """Lower + compile the jitted step that tpurt.render dispatches to for
    cfg.backend (the later render() call reuses this executable). Returns
    (seconds, memory_analysis)."""
    import jax.numpy as jnp
    t0 = time.perf_counter()
    if cfg.backend == "pallas":
        from tpurt.kernels import mega_regen
        from tpurt.kernels.mega_pallas import freeze_scene
        from tpurt.runtime import pallas_interpret
        c = mega_regen._render_regen_jit.lower(
            freeze_scene(scene), cfg, cam, state, jnp.uint32(seed),
            jnp.int32(spp), pallas_interpret(),
            depth=jnp.int32(cfg.depth)).compile()
    else:
        from tpurt.render import _render_xla
        c = _render_xla.lower(scene, cfg, cam, state, seed, spp).compile()
    return time.perf_counter() - t0, c.memory_analysis()


def timed_render(scene, cfg, cam, spp, seed=1234):
    """Compile, then one render() of `spp` samples from a fresh state."""
    import jax
    from tpurt import init_state, render
    state = init_state(cfg)
    compile_s, mem = compile_step(scene, cfg, cam, state, seed, spp)
    t0 = time.perf_counter()
    st = render(scene, cfg, cam, state, seed, spp)
    jax.block_until_ready(st)
    run_s = time.perf_counter() - t0
    return st, {"compile_s": compile_s, "run_s": run_s,
                "segments": float(st.rays),
                "segments_per_s": float(st.rays) / run_s,
                "memory_analysis": str(mem)}


def compare(st_a, st_b, n_pixels) -> dict:
    """Observed differences of two renders of the same samples."""
    import numpy as np
    ra, rb = float(st_a.rays), float(st_b.rays)
    a = np.asarray(st_a.rgb_sum)[:n_pixels]
    b = np.asarray(st_b.rgb_sum)[:n_pixels]
    d = np.abs(a - b)
    return {"rays_rel": abs(ra - rb) / max(abs(ra), 1.0),
            "median_abs": float(np.median(d)),
            "frac_gt_1e-2": float((d.max(axis=-1) > 1e-2).mean())}


def within(obs: dict, tol: dict) -> bool:
    return all(obs[k] <= tol[k] for k in obs if k in tol)


def phase_xla(width=1920, height=1080, spp=SPP, depth=30):
    """Phase 1: the XLA integrator through render(). Returns (state, info)."""
    import numpy as np
    from tpurt import resolve_image
    cfg, scene, cam = cornell(width, height, depth, backend="xla")
    st, info = timed_render(scene, cfg, cam, spp)
    img = np.asarray(resolve_image(cfg, st))
    info["ok"] = bool(np.isfinite(img).all() and img.shape
                      == (height, width, 3) and info["segments"] > 0)
    return st, info


def phase_kernel(ref_state, width=1920, height=1080, spp=SPP, depth=30,
                 **kw):
    """Phase 2: the regenerative megakernel on the same render, compared
    with the phase-1 state `ref_state`."""
    import numpy as np
    from tpurt import resolve_image
    cfg, scene, cam = cornell(width, height, depth, backend="pallas", **kw)
    st, info = timed_render(scene, cfg, cam, spp)
    img = np.asarray(resolve_image(cfg, st))
    info["compare"] = compare(ref_state, st, cfg.n_pixels)
    info["tolerance"] = TOL
    info["ok"] = bool(np.isfinite(img).all()
                      and within(info["compare"], TOL))
    return st, info


def phase_golden(**kw):
    """Phase 3: the fixed-seed 64x32 Cornell render against the golden
    capture, with tests/test_golden.py's bounds. `kw` overrides the
    RenderConfig (e.g. backend="pallas")."""
    import numpy as np
    from tpurt import init_state, render
    here = os.path.dirname(os.path.abspath(__file__))
    g = np.load(os.path.join(here, "tests", "golden",
                             "cornell_64x32_s1234_8spp.npz"))
    cfg, scene, cam = cornell(64, 32, depth=6, tile_size=2048, k_photons=2,
                              max_photon_bounces=4, **kw)
    st = render(scene, cfg, cam, init_state(cfg), 1234, 8)
    d = np.abs(np.asarray(st.rgb_sum)[:64 * 32] - g["rgb_sum"])
    obs = {"segments": float(st.rays), "golden_segments": float(g["rays"]),
           "radius_rel": abs(float(st.photon_radius)
                             - float(g["photon_radius"]))
           / float(g["photon_radius"]),
           "median_abs": float(np.median(d)),
           "frac_gt_1e-2": float((d.max(axis=-1) > 1e-2).mean())}
    ok = (obs["segments"] == obs["golden_segments"]
          and obs["radius_rel"] <= GOLDEN_TOL["radius_rtol"]
          and within(obs, GOLDEN_TOL))
    return {"observed": obs, "tolerance": GOLDEN_TOL, "ok": bool(ok)}


def four_phases(n_dev=4, width=1920, height=1080, spp=SPP, depth=30,
                torus=(45, 45), geo_size=None, geo_spp=None):
    """Every sharded step of tpurt.parallel on `n_dev` devices against the
    same render on one device. The geometry steps render a
    2*torus[0]*torus[1]-triangle torus at `geo_size` (default: width x
    height) with `geo_spp` samples (default: spp). Returns {step: info}."""
    import jax
    import jax.numpy as jnp
    from tpurt import init_state, render, torus_mesh_scene
    from tpurt.kernels.mega_pallas import N_CHANNELS
    from tpurt.parallel import geometry as geo
    from tpurt.parallel import sharding as sh
    from tpurt.render import padded_pixels

    mesh = sh.make_mesh(n_dev)
    out = {}

    def record(name, cfg, ref, got, t):
        obs = compare(ref, got, cfg.n_pixels)
        out[name] = {"compare": obs, "first_call_s": t,
                     "ok": within(obs, TOL)}
        log(f"  {name}: {json.dumps(out[name])}")

    def timed(what, fn, *a):
        # a line before each call, so a cut run shows where it stood
        log(f"  {what} ...")
        t0 = time.perf_counter()
        r = jax.block_until_ready(fn(*a))
        return r, time.perf_counter() - t0

    def single(name, cfg, scene, cam, n_spp):
        st, t = timed(f"{name}: one-device reference", render, scene, cfg,
                      cam, init_state(cfg), 1234, n_spp)
        log(f"  {name}: one-device reference {t:.1f} s, compile included")
        return st

    # pixel and sample axes of the XLA integrator
    cfg, scene, cam = cornell(width, height, depth, backend="xla")
    ref = single("xla/pixel", cfg, scene, cam, spp)
    step = sh.make_sharded_step(mesh, cfg, spp=spp)
    got, t = timed("xla/pixel", step, scene, cam,
                   sh.init_state_sharded(cfg, mesh), jnp.uint32(1234))
    record("xla/pixel", cfg, ref, got, t)

    # sample sharding is exact only without the photon pass (vispoints
    # persist blockwise per device, see make_sample_sharded_step)
    cfg_np = cfg.with_(enable_photons=False)
    ref = single("xla/sample", cfg_np, scene, cam, spp)
    step = sh.make_sample_sharded_step(mesh, cfg_np, spp=spp)
    got, t = timed("xla/sample", step, scene, cam, init_state(cfg_np),
                   jnp.uint32(1234))
    record("xla/sample", cfg_np, ref, got, t)

    # the fused kernel over pixel slabs and over sample blocks
    kcfg, scene, cam = cornell(width, height, depth, backend="pallas")
    ref = single("regen/pixel", kcfg, scene, cam, spp)
    step = sh.make_regen_sharded_step(mesh, kcfg, scene, spp=spp)
    (planes, it, rad, rays), t = timed(
        "regen/pixel", step, cam, sh.init_planes_sharded(kcfg, mesh),
        jnp.int32(0), jnp.float32(kcfg.photon_radius_init),
        jnp.float32(0.0), jnp.uint32(1234))
    got = sh.planes_to_state(kcfg, planes, it, rad, rays)
    record("regen/pixel", kcfg, ref, got, t)

    kcfg_np = kcfg.with_(enable_photons=False)
    ref = single("regen/sample", kcfg_np, scene, cam, spp)
    step = sh.make_regen_sample_sharded_step(mesh, kcfg_np, scene, spp=spp)
    zeros = jnp.zeros((N_CHANNELS, padded_pixels(kcfg_np) // 128, 128),
                      jnp.float32)
    (planes, it, rad, rays), t = timed(
        "regen/sample", step, cam, zeros, jnp.int32(0),
        jnp.float32(kcfg.photon_radius_init), jnp.float32(0.0),
        jnp.uint32(1234))
    got = sh.planes_to_state(kcfg_np, planes, it, rad, rays)
    record("regen/sample", kcfg_np, ref, got, t)

    # triangles split over the devices (1-D) and pixels x triangles (2-D),
    # on the XLA integrator's per-ray BVH (4,050 triangles by default: not
    # a multiple of the device count, so shard padding runs)
    gw, gh = geo_size or (width, height)
    gspp = geo_spp or spp
    gcfg, _, cam = cornell(gw, gh, depth, backend="xla", use_bvh=True)
    tscene = torus_mesh_scene(*torus)
    ref = single("xla/geometry", gcfg, tscene, cam, gspp)
    step = geo.make_geometry_sharded_step(mesh, gcfg, spp=gspp)
    got, t = timed("xla/geometry", step,
                   geo.split_scene_triangles(tscene, n_dev), cam,
                   init_state(gcfg), jnp.uint32(1234))
    record("xla/geometry", gcfg, ref, got, t)

    mesh2 = geo.make_2d_mesh(2, n_dev // 2)
    step = geo.make_2d_sharded_step(mesh2, gcfg, spp=gspp)
    got, t = timed("xla/pixel x geometry", step,
                   geo.split_scene_triangles(tscene, n_dev // 2), cam,
                   geo.init_state_2d(gcfg, mesh2), jnp.uint32(1234))
    record("xla/pixel x geometry", gcfg, ref, got, t)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the sharded steps on four GPUs, nothing else")
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import tpurt  # noqa: F401
    except ImportError as e:
        print(f"error: tpurt is not importable next to this script ({e})",
              file=sys.stderr)
        return 2
    import jax
    from tpurt.runtime import enable_compile_cache, require_gpu

    dev = require_gpu()
    n_need = 4 if args.four else 1
    if len(jax.devices()) < n_need:
        print(f"error: needs {n_need} GPUs, found {len(jax.devices())}",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    log(gpu_name_and_power())
    import jaxlib
    version = " ".join(str(getattr(dev.client, "platform_version",
                                   "?")).split())
    log(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}; XLA GPU "
        f"backend ({version}); fused kernel: Pallas, Triton route "
        f"(backend='triton')")

    ok = True
    if args.four:
        log("four GPUs: sharded steps vs one GPU")
        res = four_phases(geo_size=GEO_SIZE, geo_spp=GEO_SPP)
        ok = all(r["ok"] for r in res.values())
    else:
        log(f"phase 1 xla: 1920x1080 Cornell, depth 30, {SPP} spp")
        ref, info = phase_xla()
        log(json.dumps(info))
        ok &= info["ok"]
        log(f"phase 2 kernel: same render, backend='pallas'")
        _, info = phase_kernel(ref)
        log(json.dumps(info))
        ok &= info["ok"]
        log("phase 3 golden: 64x32 Cornell, 8 spp")
        info = phase_golden()
        log(json.dumps(info))
        ok &= info["ok"]
    if not ok:
        print("error: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
