"""Interactive progressive viewer + headless render loop.

The headless-host counterpart of the reference's winit app layer
(ref: src/lib.rs:26-107 event loop, :494-543 render, :545-698 input):

  * free-running progressive refinement (about_to_wait -> redraw,
    lib.rs:102-106) -> a render_step loop
  * camera move -> clear accumulation + one depth-1 preview frame
    (lib.rs:692-696, mega_kernel.rs:199-202) -> same here
  * live tonemap keys '=' '-' '[' ']' (lib.rs:602-654) -> same keys
  * scroll-zoom vfov (lib.rs:655-666) -> '+'/'-' zoom via set_vfov
  * swapchain present -> ANSI 24-bit half-block terminal blit, or PNG

There is no window system on an accelerator host, so "present" is a terminal blit
(two pixels per character cell via the upper-half-block glyph) — fully
interactive over SSH. Headless mode renders N frames and writes a PNG with
per-frame stats on stdout (SURVEY.md §5 observability: spp, Mrays/s,
photon radius; --csv for machine-readable logs).

Keys (interactive): w/a/s/d move, e/c up/down, W/A/S/D boosted,
arrow keys look, '='/'-' tonemap key, '['/']' saturation, 'z'/'x' zoom,
'r' reset accumulation, 'p' save PNG, 'h' save HDR PFM, 'q' quit.
"""

from __future__ import annotations

import argparse
import os
import select
import sys
import termios
import time
import tty

import numpy as np

# the integrator each built-in scene runs on: the fused kernel where it
# takes the scene, the XLA integrator with its per-ray BVH otherwise
SCENE_BACKEND = {"cornell": "pallas", "default": "pallas",
                 "dispersive": "pallas", "instanced": "pallas",
                 "mesh": "xla"}


def _build(args):
    from tpurt import (
        RenderConfig,
        cornell_spheres_scene,
        default_scene,
        dispersive_scene,
        instanced_scene,
        make_camera,
        torus_mesh_scene,
    )
    scenes = {
        "cornell": (cornell_spheres_scene, ((0, 5, -12), (0, 5, 0), 60.0)),
        "default": (default_scene, ((0, 0, -0.01), (0, 0, 1), 75.0)),
        "dispersive": (dispersive_scene, ((0, 3, -4), (0, 1, 5), 55.0)),
        "instanced": (lambda: instanced_scene(256), ((0, 10, -14), (0, 1, 8), 55.0)),
        "mesh": (lambda: torus_mesh_scene(45, 45), ((0, 3, -6), (0, 1.5, 0), 55.0)),
    }
    if args.scene_file:
        from tpurt.utils.scene_io import load_scene_json
        scene, cam_meta = load_scene_json(args.scene_file)
        cam_meta = cam_meta or {}
        eye = tuple(cam_meta.get("eye", (0, 3, -8)))
        at = tuple(cam_meta.get("look_at", (0, 1, 0)))
        vfov = float(cam_meta.get("vfov", 60.0))
    else:
        build, (eye, at, vfov) = scenes[args.scene]
        scene = build()
    # --set KEY=VAL (repeatable) wins over every dedicated flag: any
    # RenderConfig knob is reachable without its own CLI option. Parsed
    # up front so backend-conditional tweaks below see the EFFECTIVE
    # backend (--set backend=wavefront must behave like --backend)
    overrides = RenderConfig.parse_overrides(getattr(args, "set", None))
    backend = args.backend
    if backend == "auto":
        if args.scene_file:
            from tpurt.kernels.mega_pallas import supports_scene
            backend = ("pallas" if supports_scene(scene, RenderConfig())
                       else "xla")
        else:
            backend = SCENE_BACKEND[args.scene]
    eff_backend = overrides.get("backend", backend)
    extra = {}
    if eff_backend == "xla" and scene.num_triangles:
        extra["use_bvh"] = True
    if args.scene == "mesh" and not args.scene_file:
        # 4k triangles with the walk sampler stack (docs/DESIGN.md).
        # bench.py config 6 additionally runs hero_wavelengths=4 — pass
        # --hero 4 to match its full stack (hero stays a CLI choice here)
        extra.update(photon_strata=16, photon_strata_dir=4096,
                     photon_strata_shared_k=True, photon_strata_bounce=True,
                     camera_strata_bounce=True, photon_strata_window=8)
        if eff_backend == "wavefront":
            # the wavefront tracer rejects camera_strata_bounce (it draws
            # the unstratified sequence; photon flags are inert — no
            # photon pass) — keep the mesh scene launchable on it
            extra.pop("camera_strata_bounce")
    # CLI None = "not given" so an explicit --aperture 0 overrides a scene
    # file's camera; --focus 0/None = auto (the look-at distance)
    aperture = getattr(args, "aperture", None)
    focus = getattr(args, "focus", None)
    if args.scene_file:
        if aperture is None:
            aperture = float(cam_meta.get("aperture", 0.0))
        if not focus:
            focus = float(cam_meta.get("focus_dist", 0.0))
    if aperture is None:
        aperture = 0.0
    if not focus:
        # default focal plane: the look-at point (only matters with DOF on)
        focus = float(np.linalg.norm(np.asarray(at, np.float64)
                                     - np.asarray(eye, np.float64)))
    extra.update(overrides)
    cfg = RenderConfig(**{**dict(
        width=args.width, height=args.height, depth=args.depth,
        backend=backend, hero_wavelengths=args.hero,
        aperture=aperture, focus_dist=focus,
        radiance_clamp=getattr(args, "clamp", 0.0),
        motion_blur=getattr(args, "shutter", 0.0) > 0.0,
        dispersion_in_camera_path=args.dispersion), **extra})
    cam = make_camera(eye, at, vfov=vfov,
                      aspect_ratio=args.width / args.height)
    return cfg, scene, cam, vfov, eye, at


def _stats_line(frame, state, dt, cfg):
    rays = float(state.rays)
    return (f"frame {frame:5d}  spp {int(state.iteration):5d}  "
            f"{1.0 / max(dt, 1e-9):6.1f} fps  "
            f"radius {float(state.photon_radius):.4f}  "
            f"rays_total {rays:.3e}")


def headless(args):
    import jax
    from tpurt.render import init_state, render_step, resolve_image
    from tpurt.utils.image import write_png

    cfg, scene, cam, _, _, _ = _build(args)
    state = init_state(cfg)
    csv = open(args.csv, "w") if args.csv else None
    if csv:
        csv.write("frame,spp,seconds,mrays_per_s,photon_radius\n")

    prev_rays = 0.0
    for frame in range(args.frames):
        t0 = time.perf_counter()
        state = render_step(scene, cfg, cam, state, args.seed)
        jax.block_until_ready(state)
        dt = time.perf_counter() - t0
        rays = float(state.rays)
        print(_stats_line(frame, state, dt, cfg), file=sys.stderr)
        if csv:
            csv.write(f"{frame},{int(state.iteration)},{dt:.6f},"
                      f"{(rays - prev_rays) / dt / 1e6:.2f},"
                      f"{float(state.photon_radius):.6f}\n")
        prev_rays = rays
    if csv:
        csv.close()

    img = np.asarray(resolve_image(cfg, state))
    write_png(args.out, img)
    print(f"wrote {args.out} ({int(state.iteration)} spp)", file=sys.stderr)


# ----- terminal presentation -----

def _ansi_blit(img, max_cols, max_rows):
    """Present an (H, W, 3) [0,1] image as ANSI half-blocks (2 px/cell)."""
    h, w, _ = img.shape
    # degenerate terminals (0-row ptys, tiny panes) still get one cell row
    cols = max(1, min(max_cols, w))
    rows2 = max(2, min(max_rows * 2, h))
    ys = np.linspace(0, h - 1, rows2).astype(int)
    xs = np.linspace(0, w - 1, cols).astype(int)
    # sRGB-encode like the reference's swapchain format (lib.rs:166-171) —
    # raw linear*255 would present visibly darker than the saved PNGs,
    # which go through the same to_srgb8
    from tpurt.utils.image import to_srgb8
    small = to_srgb8(img[ys][:, xs])
    out = []
    for r in range(0, rows2 - 1, 2):
        top, bot = small[r], small[r + 1]
        line = "".join(
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
            for t, b in zip(top, bot)
        )
        out.append(line + "\x1b[0m")
    return "\n".join(out)


def _kitty_blit(img, cols: int) -> str:
    """Full-resolution in-terminal frame via the kitty graphics protocol
    (a=T transmit+display, f=100 PNG, fixed image id so each frame
    REPLACES the last; chunked base64 per the spec). This is the
    native-resolution presentation path: every rendered pixel reaches
    the screen, scaled by the terminal into `cols` columns — the
    terminal-native equivalent of the reference's 1600x900 swapchain
    present (ref: lib.rs:536-537). Supported by kitty, WezTerm, Konsole,
    ghostty; `--display ansi` keeps the half-block fallback."""
    import base64
    from tpurt.utils.image import png_bytes
    payload = base64.standard_b64encode(png_bytes(img))
    out = []
    ctrl = f"a=T,f=100,i=1,q=2,c={max(cols, 1)},"
    while payload:
        head, payload = payload[:4096], payload[4096:]
        m = 1 if payload else 0
        out.append(f"\x1b_G{ctrl}m={m};{head.decode()}\x1b\\")
        ctrl = ""  # control keys only on the first chunk
    return "".join(out)


def _pick_display(mode: str) -> str:
    """auto: kitty protocol when the terminal advertises it, else ANSI."""
    if mode != "auto":
        return mode
    if os.environ.get("KITTY_WINDOW_ID") or \
            "kitty" in os.environ.get("TERM", "") or \
            os.environ.get("TERM_PROGRAM", "") in ("WezTerm", "ghostty"):
        return "kitty"
    return "ansi"


class _RawTerm:
    def __enter__(self):
        self.fd = sys.stdin.fileno()
        self.old = termios.tcgetattr(self.fd)
        tty.setcbreak(self.fd)
        # ?1002h: xterm button-event (drag) mouse tracking; ?1006h: SGR
        # extended coordinates — the terminal-native equivalent of the
        # reference's cursor-grab + raw mouse deltas (ref: lib.rs:47-56,
        # 91-100). Terminals without mouse support ignore both silently.
        sys.stdout.write("\x1b[?25l\x1b[2J\x1b[?1002h\x1b[?1006h")
        return self

    def __exit__(self, *a):
        termios.tcsetattr(self.fd, termios.TCSADRAIN, self.old)
        sys.stdout.write("\x1b[?1002l\x1b[?1006l\x1b[?25h\x1b[0m\n")

    def keys(self):
        """Drain pending input (non-blocking); arrows -> names, SGR mouse
        reports -> ("mouse", button_bits, col, row, is_press) tuples."""
        out = []
        while select.select([self.fd], [], [], 0)[0]:
            ch = os.read(self.fd, 1).decode(errors="ignore")
            if ch != "\x1b":
                out.append(ch)
                continue
            seq = ""
            while select.select([self.fd], [], [], 0)[0] and len(seq) < 2:
                seq += os.read(self.fd, 1).decode(errors="ignore")
            if seq == "[<":  # SGR mouse report: \x1b[<b;x;y(M|m)
                body = ""
                # mid-sequence bytes may lag a tick behind the introducer;
                # a 10 ms grace beats truncating every report in half
                while (select.select([self.fd], [], [], 0.01)[0]
                       and len(body) < 16):
                    c = os.read(self.fd, 1).decode(errors="ignore")
                    if c in "Mm":
                        try:
                            b, x, y = (int(v) for v in body.split(";"))
                            out.append(("mouse", b, x, y, c == "M"))
                        except ValueError:
                            pass
                        break
                    body += c
            else:
                out.append({"[A": "up_arrow", "[B": "down_arrow",
                            "[C": "right_arrow", "[D": "left_arrow"}.get(seq, "esc"))
        return out


def interactive(args):
    import jax
    from tpurt import CameraController, set_vfov
    from tpurt.render import init_state, render_step, resolve_image
    from tpurt.utils.image import write_png

    cfg, scene, cam, vfov, _, _ = _build(args)
    display = _pick_display(args.display)
    controller = CameraController()
    state = init_state(cfg)
    key_tm, sat = cfg.tonemap_key, cfg.tonemap_saturation
    denoise = False      # 'n' toggle: a-trous filter the blit (tpurt
    aovs = None          # extension; AOVs cached until the camera moves)
    temporal = False     # 't' toggle: reproject the pre-move image while
    thist = None         # the fresh accumulation warms up (display-only —
    last_lin = None      # the accumulator itself stays exact;
    last_depth = None    # tpurt.temporal)
    last_cam = cam
    TEMPORAL_FADE = 16   # samples until the history blend reaches zero
    preview = False
    frame = 0
    t_last = time.perf_counter()

    MOVE = {"w": "forward", "s": "backward", "a": "left", "d": "right",
            "e": "up", "c": "down"}
    # dt-scaled continuous movement (ref: lib.rs:78-84 measures frame time
    # and feeds it to CameraController::update, camera.rs:186-215).  A
    # terminal has no key-up events; holding a key produces auto-repeat
    # presses, so a key counts as HELD until no repeat arrives for
    # HOLD_TIMEOUT seconds — then movement integrates the real frame dt.
    HOLD_TIMEOUT = 0.30
    held: dict[str, float] = {}     # move name -> last press time
    boost_until = 0.0
    # mouse drag-look: one terminal cell of drag ~ this many reference
    # "pixels" of raw mouse delta (a cell is ~10 px wide and twice as
    # tall; the reference feeds winit pixel deltas straight into
    # MOUSE_SCALING, camera.rs:9,161 — these factors make a full-window
    # drag sweep a comparable angle to a full-window mouse sweep there)
    DRAG_CELL_PX = (10.0, 20.0)
    drag_last = None                # (col, row) of the previous drag report

    term_size = os.get_terminal_size()

    with _RawTerm() as term:
        while True:
            changed = False
            look_dx = look_dy = 0.0
            now_keys = time.perf_counter()
            for k in term.keys():
                if isinstance(k, tuple):  # ("mouse", b, col, row, press)
                    _, b, mx, my, press = k
                    if b & 64:  # wheel: 64 up / 65 down -> scroll zoom
                        # (ref: lib.rs:655-666)
                        if press:
                            vfov = (max(5.0, vfov - 5.0) if (b & 3) == 0
                                    else min(160.0, vfov + 5.0))
                            cam = set_vfov(cam, vfov, cfg.width / cfg.height)
                            changed = True
                    elif (b & 3) == 0 and press:
                        # left button down / drag: accumulate cell deltas
                        # as reference-pixel look deltas (see DRAG_CELL_PX)
                        if (b & 32) and drag_last is not None:
                            look_dx += (mx - drag_last[0]) * DRAG_CELL_PX[0]
                            look_dy += (my - drag_last[1]) * DRAG_CELL_PX[1]
                        drag_last = (mx, my)
                    else:  # release or other button: end the drag
                        drag_last = None
                    continue
                if k == "q":
                    return
                elif k in MOVE or (k.lower() in MOVE and k.isupper()):
                    held[MOVE[k.lower()]] = now_keys
                    if k.isupper():
                        boost_until = now_keys + HOLD_TIMEOUT
                elif k in ("left_arrow", "right_arrow", "up_arrow", "down_arrow"):
                    # accumulate over the whole drain: mouse_move OVERWRITES
                    # its delta (camera.py documents the 1:1 pairing with
                    # update), so per-event calls would drop all but the
                    # last auto-repeat of a slow frame
                    look_dx += {"left_arrow": -40.0, "right_arrow": 40.0}.get(k, 0.0)
                    look_dy += {"up_arrow": -40.0, "down_arrow": 40.0}.get(k, 0.0)
                elif k == "=":
                    key_tm += 0.1           # ref: lib.rs:604-613
                elif k == "-":
                    key_tm = max(0.0, key_tm - 0.1)
                elif k == "]":
                    sat += 0.1              # ref: lib.rs:628-640
                elif k == "[":
                    sat = max(0.0, sat - 0.1)
                elif k == "z":              # scroll-zoom in (lib.rs:655-666)
                    vfov = max(5.0, vfov - 5.0)
                    cam = set_vfov(cam, vfov, cfg.width / cfg.height)
                    changed = True
                elif k == "x":
                    vfov = min(160.0, vfov + 5.0)
                    cam = set_vfov(cam, vfov, cfg.width / cfg.height)
                    changed = True
                elif k == "n":
                    denoise = not denoise
                elif k == "t":
                    temporal = not temporal
                    if not temporal:
                        thist = None
                elif k == "r":
                    changed = True
                elif k == "p":
                    if denoise:
                        from tpurt.denoise import denoise_image
                        img = np.asarray(denoise_image(
                            scene, cfg, cam, state, key=key_tm,
                            saturation=sat, aovs=aovs))
                    else:
                        img = np.asarray(resolve_image(cfg, state, key=key_tm,
                                                       saturation=sat))
                    write_png("viewer.png", img)
                elif k == "h":
                    # HDR dump: untonemapped mean radiance to float32 PFM
                    from tpurt.render import resolve_radiance
                    from tpurt.utils.image import write_pfm
                    write_pfm("viewer.pfm",
                              np.asarray(resolve_radiance(cfg, state)))

            # held-key movement: one controller update per frame with the
            # REAL frame duration, like the reference's event loop
            # (ref: lib.rs:78-84 -> camera.rs:186-215). t_last advances
            # HERE, at the same point every iteration, so dt spans the
            # whole previous frame including the render — resetting it
            # after the blit instead would feed update() only the
            # key-drain microseconds and movement would crawl.
            if look_dx or look_dy:
                controller.mouse_move(look_dx, look_dy)
            now = time.perf_counter()
            held = {n: t for n, t in held.items()
                    if now - t < HOLD_TIMEOUT}
            if held:
                controller.set_key("boost", now < boost_until)
                for name in held:
                    controller.set_key(name, True)
            dt_us = (now - t_last) * 1e6
            t_last = now
            cam, ch = controller.update(cam, dt_us)
            changed |= ch
            if held:
                for name in held:
                    controller.set_key(name, False)
                controller.set_key("boost", False)

            # terminal resize -> recreate the accumulation state at the new
            # resolution + aspect, reset iteration/radius, preview frame
            # (ref: lib.rs:545-576 resize, mega_kernel.rs:224-262)
            size = os.get_terminal_size()
            if size != term_size and display == "kitty":
                # native-res present: the terminal rescales the image into
                # the new cell width (c=cols); the render resolution is
                # the user's --width/--height and never follows the cells
                term_size = size
            elif size != term_size:
                term_size = size
                w = max(64, min(args.width, size.columns))
                h = max(36, min(args.height, (size.lines - 2) * 2))
                w -= w % 2
                h -= h % 2
                cfg = cfg.with_(width=w, height=h)
                cam = set_vfov(cam, vfov, w / h)
                state = init_state(cfg)
                preview = True
                aovs = None
                thist = last_lin = None   # history dims changed
                changed = False          # state already fresh

            if changed:
                # clear accumulation + 1-bounce preview next frame
                # (ref: lib.rs:514-526, mega_kernel.rs:199-202)
                if temporal and last_lin is not None:
                    # the displayed pre-move frame becomes the history the
                    # post-move frames reproject from
                    from tpurt.temporal import TemporalState
                    thist = TemporalState(img=last_lin, depth=last_depth,
                                          camera=last_cam)
                state = init_state(cfg)
                preview = True
                aovs = None

            # the depth-1 preview accumulates as sample 1 of the fresh
            # state, exactly like the reference's preview_next_frame (the
            # wgsl always adds to the cleared texture, mega_kernel.rs:
            # 199-201 + mega_kernel.wgsl:1016-1021) — deliberate parity
            depth = 1 if preview else None
            t_frame = time.perf_counter()
            state = render_step(scene, cfg, cam, state, args.seed, depth=depth)
            jax.block_until_ready(state)
            preview = False
            frame += 1

            if denoise or temporal:
                from tpurt import tonemap as _tm
                from tpurt.denoise import denoise_image, render_aovs
                if aovs is None:
                    aovs = render_aovs(scene, cfg, cam)
                if denoise:
                    lin = denoise_image(scene, cfg, cam, state, aovs=aovs,
                                        tonemap=False)
                else:
                    n = cfg.n_pixels
                    lin = _tm.resolve(state.rgb_sum[:n],
                                      state.n_samples[:n]) \
                        .reshape(cfg.height, cfg.width, 3)
                if temporal and thist is not None:
                    # blend fades out as the fresh accumulation converges,
                    # so the exact estimator takes over
                    fade = max(0.0, 1.0 - float(state.iteration)
                               / TEMPORAL_FADE)
                    if fade > 0.0:
                        from tpurt.temporal import reproject
                        warped, valid = reproject(thist, cam, aovs.depth)
                        import jax.numpy as _jnp
                        a = _jnp.where(valid, 0.85 * fade, 0.0)[..., None]
                        lin = (1.0 - a) * lin + a * warped
                    else:
                        thist = None
                last_lin, last_depth, last_cam = lin, aovs.depth, cam
                img = np.asarray(_tm.tonemap(lin, key_tm, sat))
            else:
                img = np.asarray(resolve_image(cfg, state, key=key_tm,
                                               saturation=sat))
                last_lin = None
            dt_frame = time.perf_counter() - t_frame
            sys.stdout.write("\x1b[H")
            if display == "kitty":
                # native-resolution present: every rendered pixel ships
                sys.stdout.write(_kitty_blit(img, size.columns))
                sys.stdout.write("\n")
            else:
                sys.stdout.write(_ansi_blit(img, size.columns,
                                            size.lines - 2))
            sys.stdout.write(
                f"\n\x1b[0m{_stats_line(frame, state, dt_frame, cfg)}  "
                f"key {key_tm:.1f} sat {sat:.1f}"
                f"{' dn' if denoise else ''}{' tp' if temporal else ''} | "
                f"wasd/ec move, arrows/drag look, z/x/wheel zoom, =/-/[/] tonemap, "
                f"n denoise, t temporal, p png, q quit\x1b[K")
            sys.stdout.flush()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", default="cornell",
                    choices=["cornell", "default", "dispersive", "instanced",
                             "mesh"])
    ap.add_argument("--scene-file", default=None, metavar="JSON",
                    help="load a JSON scene (tpurt/utils/scene_io.py "
                         "schema; overrides --scene)")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--depth", type=int, default=30)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "pallas", "xla", "wavefront"],
                    help="integrator (auto: the fused kernel for the "
                         "scenes it takes, else the XLA integrator)")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--display", default="auto",
                    choices=["auto", "ansi", "kitty"],
                    help="present frames as ANSI half-blocks (any "
                         "terminal) or native-resolution kitty-protocol "
                         "images (kitty/WezTerm/Konsole/ghostty; auto "
                         "detects)")
    ap.add_argument("--headless", action="store_true")
    ap.add_argument("--frames", type=int, default=64, help="headless frames")
    ap.add_argument("--out", default="render.png")
    ap.add_argument("--csv", default=None, help="per-frame stats CSV path")
    ap.add_argument("--hero", type=int, default=1, metavar="C",
                    help="hero-wavelength count (1 = reference estimator)")
    ap.add_argument("--dispersion", action="store_true",
                    help="Cauchy dispersion on the camera path too "
                         "(default off = the reference quirk, wgsl :915)")
    ap.add_argument("--aperture", type=float, default=None,
                    help="thin-lens diameter for depth of field "
                         "(0 = reference pinhole; unset defers to a "
                         "--scene-file camera)")
    ap.add_argument("--focus", type=float, default=None,
                    help="focus distance (default: the look-at point)")
    ap.add_argument("--clamp", type=float, default=0.0,
                    help="per-sample radiance clamp (firefly control; "
                         "0 = off)")
    ap.add_argument("--set", action="append", metavar="KEY=VAL",
                    help="override any RenderConfig field (repeatable), "
                         "e.g. --set qmc=True --set photon_strata=16")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the fused kernel then runs in "
                         "Pallas' interpret mode)")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpurt.runtime import enable_compile_cache
    enable_compile_cache()

    if args.headless or not sys.stdin.isatty():
        headless(args)
    else:
        interactive(args)


if __name__ == "__main__":
    main()
