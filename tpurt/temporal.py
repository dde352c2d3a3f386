"""Temporal reuse for animation: reproject the previous frame's image into
the current camera and blend (exponential history accumulation).

The reference is a single-camera progressive renderer — any camera change
clears the accumulator (lib.rs:514-526). For OFFLINE camera paths
(tools/animate.py) that reset wastes everything the previous frame
learned: consecutive frames see almost the same scene. This module is the
standard production alternative (TAA/SVGF-style temporal accumulation),
kept deliberately simple and offline-first:

  1. `reproject` — for every pixel of the NEW frame, take its first-hit
     world point (from the deterministic AOV pass, denoise.render_aovs),
     project it into the PREVIOUS camera, and bilinearly sample the
     previous frame's linear image. A sample is valid when it lands inside
     the previous frame and the previous depth there agrees with the
     reprojected distance (disocclusion test).
  2. `temporal_blend` — out = lerp(current, history, alpha * valid).

This is *biased* (history lags the true signal) and meant for preview /
animation smoothing, exactly like its game/film counterparts; benchmark
and convergence paths never touch it. Shape: one gather (the bilinear
fetch) + elementwise math per frame, all static shapes, one jit.

Projection math (camera.py basis): dir(u,v) = ll + u*h + v*v - o has unit
component along the forward axis fn = normalize(cross(v, h)) for every
(u, v) (the viewport plane sits at unit forward distance), so a world
point P with Q = P - o projects to Qp = Q / dot(Q, fn), and
u = (dot(Qp, hn) + 0.5*|h|) / |h| (same for v). The AOV depth is the ray
parameter t with P = o + t*dir, and dot(Q, fn) recovers exactly that t
for the camera that rendered it.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpurt.camera import Camera
from tpurt.denoise import AOVs


class TemporalState(NamedTuple):
    """History carried between frames (all (H, W, ...) arrays)."""
    img: jnp.ndarray      # (H, W, 3) linear radiance history
    depth: jnp.ndarray    # (H, W) first-hit ray parameter of that frame
    camera: Camera        # the camera that rendered the history


def _basis(cam: Camera):
    h, v = cam.horizontal, cam.vertical
    hn2 = jnp.sum(h * h)
    vn2 = jnp.sum(v * v)
    fwd = jnp.cross(v, h)
    fn = fwd / jnp.linalg.norm(fwd)
    return h, v, jnp.sqrt(hn2), jnp.sqrt(vn2), fn


@jax.jit
def reproject(prev: TemporalState, cam_new: Camera,
              depth_new, depth_tol: float = 0.05):
    """Warp the history into the new camera.

    ``depth_new`` is the NEW frame's AOV depth plane (H, W). Returns
    (warped (H, W, 3), valid (H, W) bool): valid where the new pixel hit
    something, its world point lands inside the previous frame, and the
    previous depth there matches the reprojected distance within
    ``depth_tol`` (relative) — the disocclusion test.
    """
    H, W = depth_new.shape
    x = (jnp.arange(W, dtype=jnp.float32) + 0.5) / W
    y = (jnp.arange(H, dtype=jnp.float32) + 0.5) / H
    u, v = jnp.meshgrid(x, y)

    # world point of each new first hit: P = o + t * dir(u, v)
    hN, vN, _, _, _ = _basis(cam_new)
    dirN = (cam_new.lower_left[None, None, :]
            + u[..., None] * hN[None, None, :]
            + v[..., None] * vN[None, None, :]
            - cam_new.origin[None, None, :])
    P = cam_new.origin[None, None, :] + depth_new[..., None] * dirN

    # project into the previous camera
    hP, vP, hlen, vlen, fnP = _basis(prev.camera)
    Q = P - prev.camera.origin[None, None, :]
    t_prev = jnp.sum(Q * fnP[None, None, :], axis=-1)   # forward distance
    Qp = Q / jnp.maximum(t_prev, 1e-6)[..., None]
    up = (jnp.sum(Qp * hP[None, None, :], axis=-1) / hlen + 0.5 * hlen) / hlen
    vp = (jnp.sum(Qp * vP[None, None, :], axis=-1) / vlen + 0.5 * vlen) / vlen

    # bilinear fetch from the history image (clamp BEFORE floor: a border
    # coordinate epsilon below 0 would otherwise floor to -1 and flip the
    # bilinear weight onto the neighbor texel)
    fx = jnp.clip(up * W - 0.5, 0.0, W - 1.0)
    fy = jnp.clip(vp * H - 0.5, 0.0, H - 1.0)
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    wx = fx - x0
    wy = fy - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, W - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, H - 1)
    x1i = jnp.clip(x0i + 1, 0, W - 1)
    y1i = jnp.clip(y0i + 1, 0, H - 1)

    def fetch(img, yi, xi):
        return img[yi, xi]

    c00 = fetch(prev.img, y0i, x0i)
    c01 = fetch(prev.img, y0i, x1i)
    c10 = fetch(prev.img, y1i, x0i)
    c11 = fetch(prev.img, y1i, x1i)
    wx3 = wx[..., None]
    wy3 = wy[..., None]
    warped = ((1 - wy3) * ((1 - wx3) * c00 + wx3 * c01)
              + wy3 * ((1 - wx3) * c10 + wx3 * c11))

    # validity: hit + inside frame + depth agreement at the nearest texel
    z_hist = fetch(prev.depth, jnp.clip(jnp.round(fy).astype(jnp.int32),
                                        0, H - 1),
                   jnp.clip(jnp.round(fx).astype(jnp.int32), 0, W - 1))
    inside = (up >= 0) & (up <= 1) & (vp >= 0) & (vp <= 1) & (t_prev > 0)
    z_ok = jnp.abs(z_hist - t_prev) <= depth_tol * jnp.maximum(t_prev, 1e-3)
    valid = (depth_new > 0) & inside & z_ok & (z_hist > 0)
    return warped, valid


def temporal_blend(prev: TemporalState | None,
                   cam: Camera, aovs: AOVs, img_linear,
                   alpha: float = 0.8, depth_tol: float = 0.05):
    """Blend the current frame's LINEAR image with reprojected history.

    Returns (blended (H, W, 3), TemporalState for the next frame). With
    prev=None (first frame) the image passes through. alpha is the history
    weight where reprojection is valid; disoccluded pixels fall back to
    the current frame.
    """
    alpha = min(max(float(alpha), 0.0), 1.0)   # >1 would be a feedback
    #   loop with gain > 1 (the history stores the blended output)
    if prev is None:
        blended = img_linear
    else:
        warped, valid = reproject(prev, cam, aovs.depth, depth_tol)
        a = jnp.where(valid, jnp.float32(alpha), 0.0)[..., None]
        blended = (1.0 - a) * img_linear + a * warped
    return blended, TemporalState(img=blended, depth=aovs.depth, camera=cam)
