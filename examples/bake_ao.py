"""Ambient-occlusion baking with the public ray-query API — an example of
embedding the tracer without a camera or film (docs/API.md "Ray queries").

For every point of a ground-plane grid: one closest-hit query up to find
the receiver surface, then a cosine-hemisphere batch of occlusion probes
per receiver. All queries run as flat SoA batches under one jit each —
the array way to bake: no per-texel loop, the whole light-map is one
ray batch.

    python examples/bake_ao.py [--res 128] [--rays 64] [--out /tmp/ao.png]
"""
import argparse
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # platform selection is left to the environment; --cpu forces CPU


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=128, help="AO map resolution")
    ap.add_argument("--rays", type=int, default=64, help="probes per texel")
    ap.add_argument("--span", type=float, default=9.0, help="world extent")
    ap.add_argument("--max-dist", type=float, default=4.0,
                    help="occlusion radius (world units)")
    ap.add_argument("--out", default="/tmp/ao.png")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np
    from tpurt import cornell_spheres_scene, occlusion, trace_rays
    from tpurt.utils.image import write_png

    scene = cornell_spheres_scene()
    R, S = args.res, args.rays
    # grid of downward finder rays above the scene floor
    # the Cornell box interior is x,z in (-5, 5) (wall spheres of radius
    # 1000 centered 1005 out); keep the grid inside it
    xs = np.linspace(-args.span / 2, args.span / 2, R, dtype=np.float32)
    zs = np.linspace(-args.span / 2, args.span / 2, R, dtype=np.float32)
    gx, gz = np.meshgrid(xs, zs)
    o = np.stack([gx.ravel(), np.full(R * R, 9.5, np.float32), gz.ravel()], -1)
    d = np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (R * R, 1))
    hits = trace_rays(scene, o, d)
    pos = np.asarray(hits.position)
    nrm = np.asarray(hits.normal)
    ok = np.asarray(hits.hit)

    # cosine-weighted hemisphere probes about each receiver normal
    rng = np.random.default_rng(7)
    u1 = rng.random((R * R, S), np.float32)
    u2 = rng.random((R * R, S), np.float32)
    r = np.sqrt(u1)
    phi = 2.0 * np.pi * u2
    # local frame per receiver
    up = np.where(np.abs(nrm[:, 1:2]) < 0.9,
                  np.array([[0.0, 1.0, 0.0]], np.float32),
                  np.array([[1.0, 0.0, 0.0]], np.float32))
    t1 = np.cross(up, nrm); t1 /= np.maximum(
        np.linalg.norm(t1, axis=-1, keepdims=True), 1e-8)
    t2 = np.cross(nrm, t1)
    dirs = (t1[:, None] * (r * np.cos(phi))[..., None]
            + t2[:, None] * (r * np.sin(phi))[..., None]
            + nrm[:, None] * np.sqrt(np.maximum(1.0 - u1, 0.0))[..., None])
    org = np.repeat(pos + 1e-3 * nrm, S, axis=0)
    vis = occlusion(scene, org, dirs.reshape(-1, 3), t_max=args.max_dist)
    ao = np.asarray(vis).reshape(R * R, S).mean(-1)
    ao = np.where(ok, ao, 1.0).reshape(R, R)

    img = np.repeat(ao[:, :, None], 3, axis=-1).astype(np.float32)
    write_png(args.out, img)
    print(f"wrote {args.out}  (mean AO {ao.mean():.3f}, "
          f"{R * R * (S + 1)} rays)")


if __name__ == "__main__":
    main()
