"""Camera model and interactive controller.

Capability parity with the reference (ref: src/camera.rs):
  Camera::new        :21-53   RTiOW basis: origin/horizontal/vertical/lower-left
  Camera::set_vfov   :55-69   zoom rebuilds the basis around current axes
  CameraUniform      :71-93   4 x vec4 layout -> here a (4, 3) pytree array
  CameraController   :95-263  WASD/Space/Ctrl fly, Shift boost, quaternion
                              mouse-look with vertical clamp, scroll zoom

The device-side camera is a small pytree of float32 arrays; the controller is
host-side state (it runs between frames, exactly like the reference's winit
handler) and emits a new camera pytree plus a "changed" flag that triggers
accumulation restart.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

MOUSE_SCALING = 0.0000017  # ref: camera.rs:9
FRAC_2_PI = 2.0 / math.pi


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Camera:
    """Device camera: ray(u,v) = lower_left + u*horizontal + v*vertical - origin.

    Directions are intentionally NOT normalized — the reference traces
    unnormalized primary rays (ref: mega_kernel.wgsl:267-275) and all
    intersection math is homogeneous in |d|; we preserve that contract.
    """
    origin: jnp.ndarray        # (3,)
    horizontal: jnp.ndarray    # (3,)
    vertical: jnp.ndarray      # (3,)
    lower_left: jnp.ndarray    # (3,)


def make_camera(look_from, look_at, v_up=(0.0, 1.0, 0.0), vfov=75.0, aspect_ratio=16.0 / 9.0):
    """Build the RTiOW camera basis (ref: camera.rs:21-53)."""
    look_from = np.asarray(look_from, np.float32)
    look_at = np.asarray(look_at, np.float32)
    v_up = np.asarray(v_up, np.float32)

    theta = vfov * math.pi / 180.0
    h = math.tan(theta / 2.0)
    viewport_height = 2.0 * h
    viewport_width = aspect_ratio * viewport_height

    w = look_from - look_at
    w = w / np.linalg.norm(w)
    u = np.cross(w, v_up)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)

    origin = look_from
    horizontal = viewport_width * u
    vertical = viewport_height * v
    lower_left = origin - 0.5 * horizontal - 0.5 * vertical - w
    return Camera(
        origin=jnp.asarray(origin, jnp.float32),
        horizontal=jnp.asarray(horizontal, jnp.float32),
        vertical=jnp.asarray(vertical, jnp.float32),
        lower_left=jnp.asarray(lower_left, jnp.float32),
    )


def set_vfov(cam: Camera, vfov: float, aspect_ratio: float) -> Camera:
    """Rebuild the viewport at a new vertical FOV, keeping orientation
    (ref: camera.rs:55-69)."""
    theta = vfov * math.pi / 180.0
    h = math.tan(theta / 2.0)
    viewport_height = 2.0 * h
    viewport_width = aspect_ratio * viewport_height

    hz = np.asarray(cam.horizontal)
    vt = np.asarray(cam.vertical)
    origin = np.asarray(cam.origin)
    u = hz / np.linalg.norm(hz)
    v = vt / np.linalg.norm(vt)
    w = np.cross(u, v)

    horizontal = viewport_width * u
    vertical = viewport_height * v
    lower_left = origin - 0.5 * horizontal - 0.5 * vertical - w
    return Camera(
        origin=jnp.asarray(origin, jnp.float32),
        horizontal=jnp.asarray(horizontal, jnp.float32),
        vertical=jnp.asarray(vertical, jnp.float32),
        lower_left=jnp.asarray(lower_left, jnp.float32),
    )


def generate_rays(cam: Camera, u, v):
    """Primary rays for fractional pixel coords u, v (arrays).
    Returns (origin (...,3), direction (...,3)), direction unnormalized."""
    d = (
        cam.lower_left[None, :]
        + u[..., None] * cam.horizontal[None, :]
        + v[..., None] * cam.vertical[None, :]
        - cam.origin[None, :]
    )
    o = jnp.broadcast_to(cam.origin, d.shape)
    return o, d


def lens_perturb(cam: Camera, aperture: float, focus_dist: float, o, d, rng):
    """Thin-lens defocus (tpurt extension; the reference is pinhole-only):
    jitter the ray origin uniformly over a disc of diameter ``aperture``
    in the viewport plane's basis, pivoting each ray about the focal
    plane — (o, d) -> (o + off, d - off/F), so the ray's t==F point
    o + F*d (the viewport plane sits at unit distance, making t the
    world distance along the view axis) is preserved: points at
    focus_dist render sharp, everything else defocus-blurs. The camera
    basis and the aperture==0 estimator are untouched — important because
    the reference feeds UNNORMALIZED ray directions into several terms
    (wgsl :897, :919), so any rescale of d would perturb radiance.

    Draws two uniforms (polar disc mapping: r = R*sqrt(u1), phi =
    2*pi*u2). Call order across every backend: right after the
    pixel-jitter draws, before the wavelength draw — all backends shift
    their streams identically, keeping cross-backend exactness.
    """
    if focus_dist <= 0.0:
        raise ValueError("aperture > 0 requires focus_dist > 0 "
                         "(the sharp-plane distance; see RenderConfig)")
    from tpurt.ops import rng as rngmod
    u_lens, rng = rngmod.rand_2f(rng)
    # op-for-op identical to lens_perturb_c (rsqrt, a*h_c + b*v_c) so the
    # XLA and Pallas backends produce bit-identical perturbed rays
    h, v = cam.horizontal, cam.vertical
    hinv = jax.lax.rsqrt(h[0] * h[0] + h[1] * h[1] + h[2] * h[2])
    vinv = jax.lax.rsqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    r = jnp.sqrt(u_lens[..., 0]) * jnp.float32(0.5 * aperture)
    phi = u_lens[..., 1] * jnp.float32(2.0 * math.pi)
    a = (r * jnp.cos(phi) * hinv)[..., None]
    b = (r * jnp.sin(phi) * vinv)[..., None]
    off = a * h[None, :] + b * v[None, :]
    finv = jnp.float32(1.0 / focus_dist)
    return o + off, d - off * finv, rng


def lens_perturb_c(aperture: float, focus_dist: float, rng, o0, d0,
                   cam_h, cam_v, rand_1f):
    """Component-form `lens_perturb` for the Pallas kernels: o0/d0/cam_h/
    cam_v are 3-tuples (lane arrays / scalars). Identical draws
    (rand_1f twice == rand_2f) and identical math, so kernel and XLA
    backends stay stream- and value-comparable."""
    if focus_dist <= 0.0:
        raise ValueError("aperture > 0 requires focus_dist > 0 "
                         "(the sharp-plane distance; see RenderConfig)")
    u1, rng = rand_1f(rng)
    u2, rng = rand_1f(rng)
    hn2 = cam_h[0] * cam_h[0] + cam_h[1] * cam_h[1] + cam_h[2] * cam_h[2]
    vn2 = cam_v[0] * cam_v[0] + cam_v[1] * cam_v[1] + cam_v[2] * cam_v[2]
    hinv = jax.lax.rsqrt(hn2)
    vinv = jax.lax.rsqrt(vn2)
    r = jnp.sqrt(u1) * jnp.float32(0.5 * aperture)
    phi = u2 * jnp.float32(2.0 * math.pi)
    a = r * jnp.cos(phi) * hinv
    b = r * jnp.sin(phi) * vinv
    off = tuple(a * cam_h[c] + b * cam_v[c] for c in range(3))
    finv = jnp.float32(1.0 / focus_dist)
    return (tuple(o0[c] + off[c] for c in range(3)),
            tuple(d0[c] - off[c] * finv for c in range(3)), rng)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MotionCamera:
    """Camera pose pair for shutter motion blur (tpurt extension; the
    reference has no shutter). With ``RenderConfig.motion_blur=True`` every
    backend accepts this in place of a Camera: each camera ray draws one
    shutter time u_t ~ U(0,1) and uses the basis lerp(cam0, cam1, u_t) —
    one extra uniform after the pixel jitter, at the same stream position
    in all backends, so cross-backend exactness holds with the shutter
    open. Geometry is static (camera-only blur, like the capability
    surface being matched)."""
    cam0: Camera
    cam1: Camera


def motion_rows(camera) -> jnp.ndarray:
    """(8, 3) kernel camera table for motion blur: rows 0-3 the shutter-open
    basis (origin/horizontal/vertical/lower_left), rows 4-7 the deltas to
    shutter close — the per-lane basis is row_i + u_t * row_{i+4}."""
    c0, c1 = camera.cam0, camera.cam1
    base = jnp.stack([c0.origin, c0.horizontal, c0.vertical, c0.lower_left])
    end = jnp.stack([c1.origin, c1.horizontal, c1.vertical, c1.lower_left])
    return jnp.concatenate([base, end - base], axis=0)


def lerp_camera_vecs(camera: MotionCamera, u_t):
    """Per-lane lerped basis vectors for the XLA spawn paths: returns
    (origin, horizontal, vertical, lower_left), each (..., 3) with the
    leading dims of ``u_t``."""
    c0, c1 = camera.cam0, camera.cam1
    t = u_t[..., None]

    def L(a, b):
        return a[None, :] + t * (b - a)[None, :]

    return (L(c0.origin, c1.origin), L(c0.horizontal, c1.horizontal),
            L(c0.vertical, c1.vertical), L(c0.lower_left, c1.lower_left))


def base_camera(camera) -> Camera:
    """The shutter-open Camera of either a Camera or a MotionCamera (for
    consumers that need one pose: AOVs, temporal reprojection, viewers)."""
    return camera.cam0 if isinstance(camera, MotionCamera) else camera


def lens_perturb_hv(aperture: float, focus_dist: float, h, v, o, d, rng):
    """`lens_perturb` with explicit basis vectors ((..., 3), broadcastable
    against o/d) — the motion-blur path needs the per-lane lerped basis
    instead of a single camera's. Same draws and op order."""
    if focus_dist <= 0.0:
        raise ValueError("aperture > 0 requires focus_dist > 0 "
                         "(the sharp-plane distance; see RenderConfig)")
    from tpurt.ops import rng as rngmod
    u_lens, rng = rngmod.rand_2f(rng)
    hinv = jax.lax.rsqrt(jnp.sum(h * h, axis=-1))
    vinv = jax.lax.rsqrt(jnp.sum(v * v, axis=-1))
    r = jnp.sqrt(u_lens[..., 0]) * jnp.float32(0.5 * aperture)
    phi = u_lens[..., 1] * jnp.float32(2.0 * math.pi)
    a = (r * jnp.cos(phi) * hinv)[..., None]
    b = (r * jnp.sin(phi) * vinv)[..., None]
    off = a * h + b * v
    finv = jnp.float32(1.0 / focus_dist)
    return o + off, d - off * finv, rng


def spawn_camera_rays(cfg, camera, u, v, rng):
    """Shared XLA camera-ray spawn: [shutter-time draw] -> ray gen ->
    [lens draws]. ``camera`` is a Camera, or a MotionCamera when
    cfg.motion_blur. Draw order (jitter happens at the caller):
    time, lens, then the caller's wavelength — identical in every
    backend, so cross-backend streams stay exact."""
    from tpurt.ops import rng as rngmod
    if cfg.motion_blur:
        u_t, rng = rngmod.rand_1f(rng)
        o, h, vv, ll = lerp_camera_vecs(camera, u_t)
        d = ll + u[..., None] * h + v[..., None] * vv - o
        if cfg.aperture > 0.0:
            o, d, rng = lens_perturb_hv(cfg.aperture, cfg.focus_dist,
                                        h, vv, o, d, rng)
        return o, d, rng
    o, d = generate_rays(camera, u, v)
    if cfg.aperture > 0.0:
        o, d, rng = lens_perturb(camera, cfg.aperture, cfg.focus_dist,
                                 o, d, rng)
    return o, d, rng


def _rot_axis_angle(axis, angle):
    """3x3 rotation about a unit axis (Rodrigues) — host-side numpy."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    c, s = math.cos(angle), math.sin(angle)
    C = 1.0 - c
    return np.array([
        [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
    ])


class CameraController:
    """Fly-camera controller with reference-parity semantics
    (ref: camera.rs:95-263): WASD/arrows strafe+dolly, Space/Ctrl vertical,
    Shift doubles speed, mouse-look = yaw about +Y then pitch about the
    horizontal axis with a clamp that prevents tipping past vertical.

    Drive it with `set_key(name, pressed)` / `mouse_move(dx, dy)` and call
    `update(camera, dt_micros)`; returns (new_camera, changed).
    """

    KEYS = ("forward", "backward", "left", "right", "up", "down", "boost")

    def __init__(self, default_speed: float = 5e-6):
        self.default_speed = default_speed
        self.pressed = {k: False for k in self.KEYS}
        self.mouse_delta = np.zeros(2, np.float32)
        self.mouse_dragged = False

    def set_key(self, name: str, pressed: bool):
        if name not in self.pressed:
            raise KeyError(f"unknown control {name!r}; one of {self.KEYS}")
        self.pressed[name] = pressed

    def mouse_move(self, dx: float, dy: float):
        # OVERWRITE, not accumulate — reference quirk kept deliberately
        # (camera.rs:161 assigns; events between updates drop all but the
        # last delta). Callers pairing events 1:1 with update() are fine.
        self.mouse_delta = np.array([dx, dy], np.float32)
        self.mouse_dragged = True

    def update(self, cam: Camera, duration_micros: float):
        p = self.pressed
        changed = any(p[k] for k in ("forward", "backward", "left", "right", "up", "down")) or self.mouse_dragged

        origin = np.asarray(cam.origin, np.float64)
        horizontal = np.asarray(cam.horizontal, np.float64)
        vertical = np.asarray(cam.vertical, np.float64)
        lower_left = np.asarray(cam.lower_left, np.float64)

        forward = np.cross(vertical, horizontal)
        forward_mag = np.linalg.norm(forward)
        forward_n = forward / max(forward_mag, 1e-20)
        right_n = horizontal / max(np.linalg.norm(horizontal), 1e-20)
        up = np.array([0.0, 1.0, 0.0])

        speed = self.default_speed * duration_micros * (2.0 if p["boost"] else 1.0)

        def move(delta):
            nonlocal origin, lower_left
            origin = origin + delta
            lower_left = lower_left + delta

        # the forward_mag > speed gate is the reference's own quirk
        # (camera.rs:194): |cross(v,h)| is a viewport-area scale, so a very
        # slow frame can swallow a forward press — kept for parity
        if p["forward"] and forward_mag > speed:
            move(forward_n * speed)
        if p["backward"]:
            move(-forward_n * speed)
        if p["right"]:
            move(right_n * speed)
        if p["left"]:
            move(-right_n * speed)
        if p["up"]:
            move(up * speed)
        if p["down"]:
            move(-up * speed)

        if self.mouse_dragged:
            ang_h = MOUSE_SCALING * duration_micros * self.mouse_delta[0] * FRAC_2_PI
            Rh = _rot_axis_angle(up, ang_h)
            horizontal = Rh @ horizontal
            vertical = Rh @ vertical
            lower_left = Rh @ (lower_left - origin) + origin

            ang_v = MOUSE_SCALING * duration_micros * self.mouse_delta[1] * FRAC_2_PI
            Rv = _rot_axis_angle(horizontal / np.linalg.norm(horizontal), ang_v)
            new_vertical = Rv @ vertical
            # Clamp: reject the pitch if the new vertical would align with +Y
            # (tan of the angle to +Y below threshold), ref: camera.rs:248-255.
            nv = new_vertical / max(np.linalg.norm(new_vertical), 1e-20)
            cosang = np.dot(nv, up)
            sinang = np.linalg.norm(np.cross(nv, up))  # >= 0
            tanang = sinang / cosang if cosang != 0.0 else math.inf
            if tanang < 1e-10:  # signed test, exactly as camera.rs:250
                vertical = new_vertical
                lower_left = Rv @ (lower_left - origin) + origin
            self.mouse_delta = np.zeros(2, np.float32)
            self.mouse_dragged = False

        new_cam = Camera(
            origin=jnp.asarray(origin, jnp.float32),
            horizontal=jnp.asarray(horizontal, jnp.float32),
            vertical=jnp.asarray(vertical, jnp.float32),
            lower_left=jnp.asarray(lower_left, jnp.float32),
        )
        return new_cam, bool(changed)
