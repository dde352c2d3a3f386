"""Offline animation renderer: camera paths -> numbered PNG frames.

The reference is interactive-only (ref: src/lib.rs event loop); this is the
headless counterpart: render N frames along a camera path, each converged to
--spp samples, writing frame_0000.png ... under --out-dir. All frames share
one jit compile (same shapes), so a sequence renders at full kernel
throughput after the first frame.

Camera paths:
  --orbit          turntable: the eye circles the look-at point at its
                   starting radius/height, one full revolution over the
                   sequence
  --path FILE      keyframe JSON: [{"frame": 0, "eye": [x,y,z],
                   "look_at": [x,y,z], "vfov": 60.0}, ...] — linear
                   interpolation between bracketing keyframes (vfov too)
  (neither)        fixed camera: frames differ only by seed (noise
                   realizations of one view)

Resume: existing frame files are skipped, so an interrupted render
continues where it stopped (the per-frame state is rebuilt from scratch —
frames are independent).

Usage:
  python tools/animate.py --scene cornell --orbit --frames 60 --spp 64 \
      --out-dir /tmp/anim
  python tools/animate.py --scene-file examples/torus_glass.json \
      --path path.json --frames 48 --spp 128 --out-dir /tmp/anim
"""
import sys, os as _os
sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import argparse
import json
import math
import os
import time

import numpy as np


def orbit_camera(frame, n_frames, eye0, look_at, vfov, aspect):
    """Turntable: rotate eye0 about the vertical axis through look_at."""
    from tpurt import make_camera
    ang = 2.0 * math.pi * frame / max(n_frames, 1)
    rel = np.asarray(eye0, np.float64) - np.asarray(look_at, np.float64)
    c, s = math.cos(ang), math.sin(ang)
    rot = np.array([rel[0] * c + rel[2] * s, rel[1],
                    -rel[0] * s + rel[2] * c])
    eye = np.asarray(look_at, np.float64) + rot
    return make_camera(tuple(eye), tuple(look_at), vfov=vfov,
                       aspect_ratio=aspect)


def path_camera(frame, keys, aspect):
    """Linear interpolation between bracketing keyframes (eye/look_at/vfov).
    Clamps before the first and after the last keyframe."""
    from tpurt import make_camera
    keys = sorted(keys, key=lambda k: k["frame"])
    lo = keys[0]
    hi = keys[-1]
    for a, b in zip(keys, keys[1:]):
        if a["frame"] <= frame <= b["frame"]:
            lo, hi = a, b
            break
    else:
        if frame <= keys[0]["frame"]:
            lo = hi = keys[0]
        else:
            lo = hi = keys[-1]
    span = max(hi["frame"] - lo["frame"], 1)
    t = min(max((frame - lo["frame"]) / span, 0.0), 1.0)

    def lerp3(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return tuple((1 - t) * a + t * b)

    vfov = (1 - t) * float(lo.get("vfov", 60.0)) + t * float(hi.get("vfov", 60.0))
    return make_camera(lerp3(lo["eye"], hi["eye"]),
                       lerp3(lo["look_at"], hi["look_at"]),
                       vfov=vfov, aspect_ratio=aspect)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", default="cornell",
                    choices=["cornell", "default", "dispersive", "instanced",
                             "mesh"])
    ap.add_argument("--scene-file", default=None, metavar="JSON")
    ap.add_argument("--path", default=None, metavar="JSON",
                    help="keyframe path file (overrides --orbit)")
    ap.add_argument("--orbit", action="store_true")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--depth", type=int, default=30)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "pallas", "xla", "wavefront"],
                    help="integrator (auto: viewer.SCENE_BACKEND)")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--set", action="append", metavar="KEY=VAL",
                    help="override any RenderConfig field (repeatable), "
                         "e.g. --set qmc=True (parsed by viewer._build)")
    ap.add_argument("--aperture", type=float, default=None,
                    help="thin-lens diameter for depth of field "
                         "(0 = reference pinhole)")
    ap.add_argument("--focus", type=float, default=None,
                    help="focus distance (default: the look-at point)")
    ap.add_argument("--clamp", type=float, default=0.0,
                    help="per-sample radiance clamp (firefly control; "
                         "0 = off)")
    ap.add_argument("--denoise", action="store_true",
                    help="a-trous denoise each frame (AOV-guided; lets "
                         "low --spp frames pass for converged ones)")
    ap.add_argument("--shutter", type=float, default=0.0, metavar="FRAC",
                    help="motion blur: shutter stays open for FRAC of a "
                         "frame interval (camera-only blur; orbit/path "
                         "cameras are evaluated at frame and frame+FRAC)")
    ap.add_argument("--temporal", type=float, default=0.0, metavar="ALPHA",
                    help="blend each frame with the reprojected previous "
                         "frame (history weight ALPHA, e.g. 0.8; biased "
                         "preview smoothing — tpurt.temporal; disables "
                         "frame-skip resume)")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from tpurt.runtime import enable_compile_cache
    enable_compile_cache()

    # reuse the viewer's scene/camera bootstrap (one definition of the
    # named scenes and their default cameras)
    sys.argv = [sys.argv[0]]
    import viewer
    args.hero = 1
    args.dispersion = args.scene == "dispersive"
    cfg, scene, cam0, vfov, eye0, look_at = viewer._build(args)
    from tpurt import init_state, render
    from tpurt.render import resolve_image
    from tpurt.utils.image import write_png

    keys = None
    if args.path:
        with open(args.path) as f:
            keys = json.load(f)
        if not keys:
            ap.error("--path file holds no keyframes")


    os.makedirs(args.out_dir, exist_ok=True)
    aspect = args.width / args.height
    done = 0
    tstate = None   # temporal history (tpurt.temporal)
    for frame in range(args.frames):
        out = os.path.join(args.out_dir, f"frame_{frame:04d}.png")
        if os.path.exists(out) and not args.temporal:
            # temporal mode re-renders everything: skipping a frame would
            # hole the history chain
            continue
        def cam_at(f):
            if keys is not None:
                return path_camera(f, keys, aspect)
            if args.orbit:
                return orbit_camera(f, args.frames, eye0, look_at, vfov,
                                    aspect)
            return cam0  # fixed camera: frames differ only by seed

        cam = cam_at(frame)
        if args.shutter > 0.0:
            from tpurt.camera import MotionCamera
            cam = MotionCamera(cam0=cam, cam1=cam_at(frame + args.shutter))
        t0 = time.perf_counter()
        st = render(scene, cfg, cam, init_state(cfg), args.seed + frame,
                    args.spp)
        if args.denoise or args.temporal:
            from tpurt import tonemap as tm
            from tpurt.denoise import denoise_image, render_aovs
            aovs = render_aovs(scene, cfg, cam)
            if args.denoise:
                lin = denoise_image(scene, cfg, cam, st, aovs=aovs,
                                    tonemap=False)
            else:
                n = cfg.n_pixels
                lin = tm.resolve(st.rgb_sum[:n], st.n_samples[:n]) \
                    .reshape(cfg.height, cfg.width, 3)
            if args.temporal:
                from tpurt.camera import base_camera
                from tpurt.temporal import temporal_blend
                lin, tstate = temporal_blend(tstate, base_camera(cam),
                                             aovs, lin,
                                             alpha=args.temporal)
            img = np.asarray(tm.tonemap(lin, cfg.tonemap_key,
                                        cfg.tonemap_saturation))
        else:
            img = np.asarray(resolve_image(cfg, st))
        write_png(out, img)
        dt = time.perf_counter() - t0
        done += 1
        print(f"frame {frame:4d}  {args.spp} spp  {dt:6.2f}s  "
              f"{float(st.rays) / dt / 1e6:8.1f} Mrays/s  -> {out}",
              file=sys.stderr)
    print(json.dumps({"frames_rendered": done, "out_dir": args.out_dir,
                      "spp": args.spp}))


if __name__ == "__main__":
    main()
