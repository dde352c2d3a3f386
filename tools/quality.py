"""Estimator-quality probe: variance at equal spp for sampler flag stacks.

The perf flags (photon_strata*, camera_strata_bounce, hero_wavelengths,
pallas_regen_drift) must not silently trade image quality for Mrays/s.
All are unbiased (strata remaps are measure-preserving per sample;
drift is scheduling-only), so the honest cost metric is *variance at
equal spp*: render R independent S-spp images per flag set (different
seeds), average per-pixel sample variance of the resolved image, and
report each stack's efficiency relative to the reference sampler
(ratio > 1: fewer samples for equal noise; < 1: structured per-sample
correlation costs variance that extra throughput must buy back).

XLA-backend by design (estimator-level property, identical across
backends — the cross-backend exactness tests pin that). Runs on the CPU
by default; set QUALITY_PLATFORM=gpu to run on the GPU instead.

Usage: python tools/quality.py [--spp 16] [--reps 8] [--scene config3]
Prints one JSON line per flag stack.
"""
import sys, os as _os
sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import argparse
import json

import jax
# the estimator is platform-identical; QUALITY_PLATFORM names where to
# run it (any value but "cpu" leaves JAX's default device in charge)
if _os.environ.get("QUALITY_PLATFORM", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
import numpy as np


STACKS = {
    "reference": {},
    "strata16": dict(photon_strata=16),
    "K2": dict(photon_strata=16, photon_strata_dir=256,
               photon_strata_shared_k=True, photon_strata_bounce=True,
               camera_strata_bounce=True),
    "K2h": dict(photon_strata=16, photon_strata_dir=256,
                photon_strata_shared_k=True, photon_strata_bounce=True,
                camera_strata_bounce=True, hero_wavelengths=4),
    "K2h_w8": dict(photon_strata=16, photon_strata_dir=256,
                   photon_strata_shared_k=True, photon_strata_bounce=True,
                   camera_strata_bounce=True, hero_wavelengths=4,
                   photon_strata_window=8),
    "mesh1024": dict(photon_strata=16, photon_strata_dir=1024,
                     photon_strata_shared_k=True, photon_strata_bounce=True,
                     camera_strata_bounce=True, photon_strata_window=8),
    # the shipped bench config-3 stack (round 2): window16 + hero8
    "K2h8_w16": dict(photon_strata=16, photon_strata_dir=256,
                     photon_strata_shared_k=True, photon_strata_bounce=True,
                     camera_strata_bounce=True, hero_wavelengths=8,
                     photon_strata_window=16),
    # the rejected wider-window candidate, kept for comparison
    "K2h_w32": dict(photon_strata=16, photon_strata_dir=256,
                    photon_strata_shared_k=True, photon_strata_bounce=True,
                    camera_strata_bounce=True, hero_wavelengths=4,
                    photon_strata_window=32),
    # the shipped mesh stack (bench.py config 6 / viewer.py mesh scene).
    # pallas_regen_drift is deliberately NOT set: it is pure SCHEDULING in
    # the regen kernel (bit-identical samples) and inert on this probe's
    # XLA backend — listing it here would only fake coverage.
    "mesh_ship": dict(photon_strata=16, photon_strata_dir=4096,
                      photon_strata_shared_k=True, photon_strata_bounce=True,
                      camera_strata_bounce=True, hero_wavelengths=4,
                      photon_strata_window=8),
    # round-3 shipped stacks: drift=1 makes per-sample (window=1) epochs
    # tile-coherent again, so the wide windows' variance compromise is
    # gone (drift is scheduling-only and inert on this XLA probe; listed
    # stacks measure the WINDOW change the drift enables)
    "K2h8_w1": dict(photon_strata=16, photon_strata_dir=256,
                    photon_strata_shared_k=True, photon_strata_bounce=True,
                    camera_strata_bounce=True, hero_wavelengths=8,
                    photon_strata_window=1),
    "mesh_ship_w1": dict(photon_strata=16, photon_strata_dir=4096,
                         photon_strata_shared_k=True,
                         photon_strata_bounce=True,
                         camera_strata_bounce=True, hero_wavelengths=4,
                         photon_strata_window=1),
    # config-3 candidates with WIDE windows: a 64-sample window folds many
    # samples into one emission-cell epoch, so its variance cost is
    # measured here
    "K2h8_w32": dict(photon_strata=16, photon_strata_dir=256,
                     photon_strata_shared_k=True, photon_strata_bounce=True,
                     camera_strata_bounce=True, hero_wavelengths=8,
                     photon_strata_window=32),
    "K2h8_w64": dict(photon_strata=16, photon_strata_dir=256,
                     photon_strata_shared_k=True, photon_strata_bounce=True,
                     camera_strata_bounce=True, hero_wavelengths=8,
                     photon_strata_window=64),
    "K2h8_w64_d512": dict(photon_strata=16, photon_strata_dir=512,
                      photon_strata_shared_k=True,
                      photon_strata_bounce=True,
                      camera_strata_bounce=True, hero_wavelengths=8,
                      photon_strata_window=64),
    "K2h8_w64_d1024": dict(photon_strata=16, photon_strata_dir=1024,
                       photon_strata_shared_k=True,
                       photon_strata_bounce=True,
                       camera_strata_bounce=True, hero_wavelengths=8,
                       photon_strata_window=64),
    "K2h8_w128": dict(photon_strata=16, photon_strata_dir=256,
                      photon_strata_shared_k=True,
                      photon_strata_bounce=True,
                      camera_strata_bounce=True, hero_wavelengths=8,
                      photon_strata_window=128),
    # w64 with K-diverse emission cells (shared_k off): 4x the cell
    # diversity inside the long epoch, a variance-recovery candidate
    "K2h8_w64_nok": dict(photon_strata=16, photon_strata_dir=256,
                         photon_strata_bounce=True,
                         camera_strata_bounce=True, hero_wavelengths=8,
                         photon_strata_window=64),
    # importance-aimed photon emission (cfg.photon_aim, r2): alone and on
    # top of the shipped config-3 stack (aimed lanes leave the shared
    # strata beam, so the combination must be measured, not assumed)
    "aim50": dict(photon_aim=0.5),
    "aim80": dict(photon_aim=0.8),
    "K2h8_w16_aim50": dict(photon_strata=16, photon_strata_dir=256,
                           photon_strata_shared_k=True,
                           photon_strata_bounce=True,
                           camera_strata_bounce=True, hero_wavelengths=8,
                           photon_strata_window=16, photon_aim=0.5),
}


def build(scene_name):
    from tpurt import (RenderConfig, instanced_scene, make_camera,
                       torus_mesh_scene, cornell_spheres_scene)
    if scene_name == "config3":
        scene = instanced_scene(64)   # shrunk twin of the 257-instance bench
        cam = make_camera((0, 10, -14), (0, 1, 8), vfov=55.0,
                          aspect_ratio=2.0)
        kw = dict(width=64, height=32, depth=16)
    elif scene_name == "mesh":
        scene = torus_mesh_scene(16, 8)
        cam = make_camera((0, 3, -6), (0, 1.5, 0), vfov=55.0,
                          aspect_ratio=2.0)
        kw = dict(width=64, height=32, depth=16)
    elif scene_name == "field":
        # shrunk twin of the spatially-distributed field scene (bench
        # config 9): 4 small tori spread on the ground — measures whether
        # the strata machinery still pays when shadow/photon traffic
        # crosses several objects (VERDICT r3 item 8)
        from tpurt import torus_field_scene
        scene = torus_field_scene(4, 12, 6)
        cam = make_camera((0, 14, -16), (0, 1, 10), vfov=55.0,
                          aspect_ratio=2.0)
        kw = dict(width=64, height=32, depth=16)
    else:
        scene = cornell_spheres_scene()
        cam = make_camera((0, 5, -12), (0, 5, 0), vfov=60.0,
                          aspect_ratio=2.0)
        kw = dict(width=64, height=32, depth=8)
    return scene, cam, kw


def adaptive_probe(args):
    """Adaptive-vs-uniform at equal mean spp: MSE against a converged
    ground truth, cost in actually-traced rays, efficiency at equal rays
    eff = (mse_u * rays_u) / (mse_a * rays_a)  (> 1: adaptive reaches the
    same error with proportionally fewer rays). Raw (linear) means, no
    tonemap — the MC-estimator metric. --adaptive-backend wavefront =
    camera+NEE only; pallas = the FULL estimator (photons + per-pixel
    SPPM radii) through the regen budget kernel (interpret mode here)."""
    from tpurt import RenderConfig, init_state, render_adaptive
    scene, cam, kw = build(args.scene)
    if args.adaptive_backend == "pallas":
        from tpurt.render import render
        cfg = RenderConfig(backend="pallas", hero_wavelengths=args.hero,
                           **kw)
        uniform_render = render
    else:
        from tpurt.wavefront import wavefront_render as uniform_render
        cfg = RenderConfig(backend="wavefront", enable_photons=False,
                           wf_pool=4096, hero_wavelengths=args.hero, **kw)
    n = cfg.n_pixels

    def raw(st):
        return (np.asarray(st.rgb_sum, np.float64)[:n]
                / np.maximum(np.asarray(st.n_samples, np.float64)[:n, None], 1))

    gt_st = uniform_render(scene, cfg, cam, init_state(cfg), 999331,
                           args.gt_spp)
    gt = raw(gt_st)

    res = {"uniform": ([], []), "adaptive": ([], [])}
    for rep in range(args.reps):
        seed = 1000 + 7919 * rep
        st_u = uniform_render(scene, cfg, cam, init_state(cfg), seed,
                              args.spp)
        res["uniform"][0].append(((raw(st_u) - gt) ** 2).mean())
        res["uniform"][1].append(float(st_u.rays))
        st_a, _ = render_adaptive(scene, cfg, cam, base_seed=seed,
                                  spp=args.spp,
                                  pilot_spp=max(2, args.spp // 8) // 2 * 2)
        res["adaptive"][0].append(((raw(st_a) - gt) ** 2).mean())
        res["adaptive"][1].append(float(st_a.rays))

    mse_u, rays_u = (float(np.mean(v)) for v in res["uniform"])
    mse_a, rays_a = (float(np.mean(v)) for v in res["adaptive"])
    print(json.dumps({
        "scene": args.scene, "spp": args.spp, "reps": args.reps,
        "gt_spp": args.gt_spp, "hero": args.hero, "mse_uniform": round(mse_u, 6),
        "mse_adaptive": round(mse_a, 6),
        "rays_uniform": rays_u, "rays_adaptive": rays_a,
        "backend": args.adaptive_backend,
        "eff_equal_rays": round((mse_u * rays_u) / (mse_a * rays_a), 3),
    }), flush=True)


def _rel_var_reps(scene, cfg, cam, spp, reps):
    """The shared scoring block: render `reps` independent spp-sample
    images (seeds 1000 + 7919*rep), return (rel_var_rgb, mean_rays, imgs)
    — per-pixel sample variance of the resolved image, normalized by the
    scene's own mean scale (so scores compare across flag stacks)."""
    from tpurt import init_state, render, resolve_image
    imgs, rays = [], []
    for rep in range(reps):
        st = render(scene, cfg, cam, init_state(cfg), 1000 + 7919 * rep, spp)
        imgs.append(np.asarray(resolve_image(cfg, st), np.float64))
        rays.append(float(st.rays))
    imgs = np.stack(imgs)                        # (reps, H, W, 3)
    mean = imgs.mean(0)
    var = ((imgs - mean) ** 2).sum(0) / (len(imgs) - 1)
    score = float(var.mean() / max(np.abs(mean).mean() ** 2, 1e-12))
    return score, float(np.mean(rays)), imgs


def lights_probe(args):
    """Many-light NEE ("all" vs "power" at equal spp), scored at equal
    RAYS: power mode trades one stochastically-chosen light per bounce
    (higher variance per sample) for L-fold fewer shadow sweeps, so the
    honest metric is eff = (var_all * rays_all) / (var_power * rays_power)
    (> 1: power reaches equal noise with fewer total segments)."""
    from tpurt import RenderConfig, make_camera, many_light_scene
    scene = many_light_scene(args.n_lights)
    cam = make_camera((0, 5, -12), (0, 5, 0), vfov=60.0, aspect_ratio=2.0)
    kw = dict(width=64, height=32, depth=8,
              enable_photons=not args.no_photons)
    out = {}
    for mode in ("all", "power", "spatial"):
        cfg = RenderConfig(backend="xla", light_sample=mode, **kw)
        score, mrays, _ = _rel_var_reps(scene, cfg, cam, args.spp, args.reps)
        out[mode] = (score, mrays)
        print(json.dumps({
            "scene": f"lights{args.n_lights}", "spp": args.spp,
            "reps": args.reps, "photons": not args.no_photons,
            "light_sample": mode, "rel_var_rgb": round(score, 5),
            "rays": out[mode][1],
        }), flush=True)
    for mode in ("power", "spatial"):
        eff = (out["all"][0] * out["all"][1]
               / (out[mode][0] * out[mode][1]))
        print(json.dumps({
            "scene": f"lights{args.n_lights}", "mode": mode,
            "eff_equal_rays_vs_all": round(eff, 3),
            "rays_ratio_all_over_mode": round(
                out["all"][1] / out[mode][1], 3),
            "var_ratio_mode_over_all": round(
                out[mode][0] / out["all"][0], 3),
        }), flush=True)


def rr_probe(args):
    """Photon RR scaling (cfg.photon_rr_scale) scored at equal RAYS:
    scale < 1 kills photon walks earlier (fewer segments) at the cost of
    deep-photon variance, so the honest metric is
    eff = (var_1 * rays_1) / (var_s * rays_s) (> 1: the scaled RR
    reaches equal noise with fewer total segments)."""
    from tpurt import RenderConfig
    scene, cam, kw = build(args.scene)
    kw = dict(kw, width=64, height=32, backend="xla")
    kw.update(RenderConfig.parse_overrides(args.set))
    out = {}
    for scale in (1.0, 0.7, 0.5, 0.35):
        cfg = RenderConfig(photon_rr_scale=scale, **kw)
        score, mrays, _ = _rel_var_reps(scene, cfg, cam, args.spp, args.reps)
        out[scale] = (score, mrays)
        eff = (out[1.0][0] * out[1.0][1]) / max(score * out[scale][1], 1e-30)
        print(json.dumps({
            "scene": args.scene, "spp": args.spp, "reps": args.reps,
            "photon_rr_scale": scale, "rel_var_rgb": round(score, 5),
            "rays": out[scale][1],
            "eff_equal_rays_vs_1": round(eff, 3),
        }), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--reps", type=int, default=8)

    ap.add_argument("--scene", default="config3",
                    choices=["config3", "mesh", "cornell", "field"])
    ap.add_argument("--stacks", nargs="*", default=list(STACKS))
    ap.add_argument("--adaptive", action="store_true",
                    help="adaptive-vs-uniform equal-ray MSE probe instead "
                         "of the flag-stack variance sweep")
    ap.add_argument("--gt-spp", type=int, default=512)
    ap.add_argument("--adaptive-backend", default="wavefront",
                    choices=["wavefront", "pallas"],
                    help="pallas = full estimator (photons) through the "
                         "regen budget kernel, interpret mode")
    ap.add_argument("--hero", type=int, default=1,
                    help="hero_wavelengths for the adaptive probe (hero>1 "
                         "removes global chroma noise so the probe sees the "
                         "spatially-heterogeneous path noise)")
    ap.add_argument("--lights", action="store_true",
                    help="many-light NEE probe: light_sample all-vs-power "
                         "at equal spp, scored at equal rays")
    ap.add_argument("--n-lights", type=int, default=16)
    ap.add_argument("--no-photons", action="store_true",
                    help="lights probe: camera+NEE only (photon segments "
                         "are mode-independent and dilute the ray ratio)")
    ap.add_argument("--rr", action="store_true",
                    help="photon RR scaling probe: photon_rr_scale sweep "
                         "at equal spp, scored at equal rays")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VAL",
                    help="extra RenderConfig overrides for the rr probe "
                         "(e.g. --set hero_wavelengths=4)")
    args = ap.parse_args()
    if args.reps < 2:
        ap.error("--reps must be >= 2 (sample variance divides by reps-1)")
    if args.adaptive:
        adaptive_probe(args)
        return
    if args.lights:
        lights_probe(args)
        return
    if args.rr:
        rr_probe(args)
        return

    from tpurt import RenderConfig
    scene, cam, kw = build(args.scene)

    ref_var = None
    for name in args.stacks:
        flags = STACKS[name]
        cfg = RenderConfig(backend="xla", **kw, **flags)
        # two variance views, both normalized by the scene's own scale:
        # - rgb: total per-channel variance (dominated by single-lambda
        #   CHROMA noise in spectral scenes — the component hero-
        #   wavelength sampling collapses)
        # - luma: Rec.709 luminance variance (the PATH/geometry noise
        #   that strata correlation could inflate)
        score, _, imgs = _rel_var_reps(scene, cfg, cam, args.spp, args.reps)
        w709 = np.array([0.2126, 0.7152, 0.0722])
        luma = imgs @ w709
        lmean = luma.mean(0)
        lvar = ((luma - lmean) ** 2).sum(0) / (len(imgs) - 1)
        lscore = float(lvar.mean() / max(np.abs(lmean).mean() ** 2, 1e-12))
        if name == "reference":
            ref_var = (score, lscore)
        print(json.dumps({
            "scene": args.scene, "spp": args.spp, "reps": args.reps,
            "stack": name, "rel_var_rgb": round(score, 5),
            "rel_var_luma": round(lscore, 5),
            "eff_rgb": round(ref_var[0] / score, 3) if ref_var else None,
            "eff_luma": round(ref_var[1] / lscore, 3) if ref_var else None,
        }), flush=True)


if __name__ == "__main__":
    main()
