"""Scene construction: pytree Structure-of-Arrays buffers for the device.

Capability parity with the reference host layer (ref: src/lib.rs:220-447 and
src/{instance,material,light}.rs): materials (diffuse / dielectric), unit
spheres with transform+scale, OBJ meshes with a baked T*R*S transform, point
and square-area lights, and a CPU-built BVH.  The reference packs #[repr(C)]
byte structs for wgpu bind groups; here the device format is a pytree of
float32/int32 SoA arrays — the natural accelerator layout (contiguous lanes per
field, no interleaving, no padding bytes).

Deviations from the reference layout, all documented inline:
  * spheres store (center, radius) instead of a mat4 transform — the kernel
    only ever uses transform*origin and scale (ref: mega_kernel.wgsl:280-281),
    so the matrix is dead weight on device;
  * triangles are pre-gathered into (a, e1, e2, n) arrays in BVH-leaf order,
    removing both the index and vertex gathers from the inner loop;
  * sphere materials are pre-resolved (mtype, ior) for the shadow pass so
    shadow rays never chase material ids;
  * all primitive arrays may be padded with inert entries (radius 0,
    degenerate triangles, intensity-0 lights with valid=0).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from tpurt import accel


# ----- Host-side builder objects (API parity with the reference types) -----

@dataclasses.dataclass(frozen=True)
class Material:
    """ref: src/material.rs:1-31 — type 0 diffuse(albedo), 1 dielectric(ior,
    roughness). Type 2 metal (GGX conductor, color = F0 Schlick reflectance)
    is an extension beyond the reference's two types — BASELINE.json
    config 4 names 'metal materials' as part of the finished spectral bench."""
    color: tuple = (0.0, 0.0, 0.0)
    roughness: float = 0.0
    ior: float = 1.0
    mtype: int = 0

    @staticmethod
    def diffuse(color, roughness: float = 0.0) -> "Material":
        return Material(color=tuple(color), roughness=roughness, ior=1.0, mtype=0)

    @staticmethod
    def dielectric(ior: float, roughness: float) -> "Material":
        return Material(color=(0.0, 0.0, 0.0), roughness=roughness, ior=ior, mtype=1)

    @staticmethod
    def metal(f0_color, roughness: float = 0.0) -> "Material":
        """GGX conductor; f0_color = reflectance at normal incidence
        (e.g. gold ~ (1.0, 0.71, 0.29), silver ~ (0.95, 0.93, 0.88))."""
        return Material(color=tuple(f0_color), roughness=roughness, ior=1.0,
                        mtype=2)

    @staticmethod
    def emissive(color, intensity: float = 1.0) -> "Material":
        """Type-3 emitter (EXTENSION — the reference's lights have no
        geometry and never appear in frame). A camera path hitting this
        surface adds color*intensity * cie_to_rgb(lambda) * range (the
        lights' flat-spectrum emission form, mega_kernel.wgsl:574-578) and
        terminates; photons are absorbed; shadow rays are fully occluded
        (like diffuse). Not sampled by NEE — pair with a Light record at
        the same place when direct-light sampling matters."""
        return Material(color=tuple(float(intensity) * c for c in color),
                        roughness=0.0, ior=1.0, mtype=3)


@dataclasses.dataclass(frozen=True)
class Sphere:
    """ref: src/instance.rs:5-33 — unit sphere, translation+rotation transform,
    scale = radius. Rotation doesn't affect a sphere's geometry; we keep the
    argument for API parity but only the translation (center) reaches device."""
    material_id: int
    scale: float
    translation: tuple
    rotation_deg: float = 0.0

    @property
    def center(self):
        return np.asarray(self.translation, np.float32)


@dataclasses.dataclass(frozen=True)
class Light:
    """ref: src/light.rs — type 0 point, 1 square area (normal forced downward)."""
    position: tuple
    color: tuple
    intensity: float
    color_temp: float
    ltype: int
    half_width: float = 0.0
    normal: tuple = (0.0, -1.0, 0.0)

    @staticmethod
    def point(position, color, intensity, color_temp=0.0) -> "Light":
        return Light(tuple(position), tuple(color), intensity, color_temp, ltype=0)

    @staticmethod
    def square_area(center, normal, half_width, color, intensity, color_temp=0.0) -> "Light":
        n = np.asarray(normal, np.float64)
        ln = np.linalg.norm(n)
        n = n / ln if ln > 0 else np.array([0.0, -1.0, 0.0])
        if n[1] > 0:  # always face downward (ref: light.rs:39-40)
            n = -n
        return Light(tuple(center), tuple(color), intensity, color_temp,
                     ltype=1, half_width=half_width, normal=tuple(n))


class MeshData:
    """Host triangle soup with a baked T*R*S transform
    (ref: src/instance.rs:35-124; rotation about +Y as in the reference)."""

    def __init__(self, material_id: int = 0, translation=(0.0, 0.0, 0.0),
                 rotation_deg: float = 0.0, scale: float = 1.0):
        self.material_id = material_id
        self.translation = np.asarray(translation, np.float32)
        self.rotation_deg = float(rotation_deg)
        self.scale = float(scale)
        self.positions = np.zeros((0, 3), np.float32)
        self.indices = np.zeros((0, 3), np.int32)
        self.tri_material = np.zeros((0,), np.int32)

    def _xform(self, pts: np.ndarray) -> np.ndarray:
        th = math.radians(self.rotation_deg)
        c, s = math.cos(th), math.sin(th)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        return pts * self.scale @ rot.T + self.translation

    def add_triangles(self, positions: np.ndarray, indices: np.ndarray,
                      tri_material: np.ndarray | None = None):
        """Append raw triangles; positions are transformed by the baked TRS.

        tri_material (T,) overrides the mesh-wide material_id per face —
        the device scene carries per-triangle ids (Scene.tri_mat), the
        reference's single-id-per-mesh layout (instance.rs:88-92) is just
        the uniform special case.
        """
        base = self.positions.shape[0]
        self.positions = np.concatenate([self.positions, self._xform(np.asarray(positions, np.float32))])
        idx = np.asarray(indices, np.int32) + base
        self.indices = np.concatenate([self.indices, idx])
        if tri_material is None:
            tri_material = np.full((idx.shape[0],), self.material_id, np.int32)
        else:
            tri_material = np.asarray(tri_material, np.int32)
            if tri_material.shape != (idx.shape[0],):
                raise ValueError(
                    f"tri_material shape {tri_material.shape} != ({idx.shape[0]},)")
        self.tri_material = np.concatenate([self.tri_material, tri_material])

    def load_obj(self, path: str, materials: list | None = None):
        """Load an OBJ file into this mesh.

        With `materials` (a mutable list of Material) the loader honors
        `mtllib`/`usemtl`: each named MTL material is mapped via
        `utils.obj.mtl_to_material`, appended to `materials`, and its faces
        get that per-face id. Faces before any `usemtl`, or whose name has
        no definition, fall back to this mesh's material_id. Without
        `materials` every face uses material_id (reference behavior,
        src/lib.rs:267-271).
        """
        if materials is None:
            from tpurt.utils.obj import parse_obj
            positions, indices = parse_obj(path)
            self.add_triangles(positions, indices)
        else:
            from tpurt.utils.obj import parse_obj_mtl, mtl_to_material
            positions, indices, tri_slot, slot_names, mtl_defs = parse_obj_mtl(path)
            slot_to_id = np.full((len(slot_names),), self.material_id, np.int32)
            for slot, name in enumerate(slot_names):
                if name is not None and name in mtl_defs:
                    slot_to_id[slot] = len(materials)
                    materials.append(mtl_to_material(mtl_defs[name]))
            self.add_triangles(positions, indices,
                               tri_material=slot_to_id[tri_slot]
                               if indices.shape[0] else None)
        print(f"Loading model: {path} ({indices.shape[0]} triangles)")

    def num_triangles(self) -> int:
        return self.indices.shape[0]


# ----- Device scene pytree -----

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Scene:
    # spheres
    sph_center: jnp.ndarray      # (S, 3) f32
    sph_radius: jnp.ndarray      # (S,)   f32 — 0 marks padding
    sph_mat: jnp.ndarray         # (S,)   i32
    sph_mtype: jnp.ndarray       # (S,)   i32 — resolved material type
    sph_ior: jnp.ndarray         # (S,)   f32 — resolved base IOR
    # materials
    mat_color: jnp.ndarray       # (M, 3) f32
    mat_rough: jnp.ndarray       # (M,)   f32
    mat_ior: jnp.ndarray         # (M,)   f32
    mat_type: jnp.ndarray        # (M,)   i32
    # triangles (leaf order)
    tri_a: jnp.ndarray           # (T, 3) f32
    tri_e1: jnp.ndarray          # (T, 3) f32
    tri_e2: jnp.ndarray          # (T, 3) f32
    tri_n: jnp.ndarray           # (T, 3) f32 — unit geometric normal
    tri_mat: jnp.ndarray         # (T,)   i32
    # BVH over triangles (leaf ranges index tri_* directly)
    bvh_min: jnp.ndarray         # (B, 3) f32
    bvh_max: jnp.ndarray         # (B, 3) f32
    bvh_left: jnp.ndarray        # (B,)   i32
    bvh_right: jnp.ndarray       # (B,)   i32
    bvh_first: jnp.ndarray       # (B,)   i32
    bvh_count: jnp.ndarray       # (B,)   i32
    # lights
    light_pos: jnp.ndarray       # (L, 3) f32
    light_hw: jnp.ndarray        # (L,)   f32 — half width (area lights)
    light_color: jnp.ndarray     # (L, 3) f32
    light_intensity: jnp.ndarray # (L,)   f32
    light_temp: jnp.ndarray      # (L,)   f32 — blackbody K; <=0 -> flat SPD
    light_type: jnp.ndarray      # (L,)   i32 — 0 point, 1 square area
    light_normal: jnp.ndarray    # (L, 3) f32
    # static (pytree metadata, compile-time): the build-time leaf capacity —
    # the traversal's per-leaf loop bound must cover it (fixes a silent
    # miss when built with max_leaf_prims > the traversal default)
    bvh_max_leaf: int = dataclasses.field(default=2,
                                          metadata=dict(static=True))

    @property
    def num_spheres(self) -> int:
        return self.sph_center.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.tri_a.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_pos.shape[0]

    def bvh_dict(self):
        """BVH + triangle arrays bundled for tpurt.ops.intersect.bvh_hit."""
        return {
            "bbox_min": self.bvh_min, "bbox_max": self.bvh_max,
            "left": self.bvh_left, "right": self.bvh_right,
            "first": self.bvh_first, "count": self.bvh_count,
            "tri_a": self.tri_a, "tri_e1": self.tri_e1,
            "tri_e2": self.tri_e2, "tri_n": self.tri_n,
            "tri_mat": self.tri_mat,
        }


def build_scene(
    materials: Sequence[Material],
    spheres: Sequence[Sphere] = (),
    meshes: Sequence[MeshData] = (),
    lights: Sequence[Light] = (),
    max_leaf_prims: int = 2,
    bvh_builder=None,
) -> Scene:
    """Pack host builder objects into the device Scene pytree.

    Mirrors State::new's buffer packing (ref: src/lib.rs:220-447): triangles
    from all meshes are merged, a BVH is built CPU-side (median split, leaf
    <= max_leaf_prims), and triangle SoA arrays are permuted into leaf order.
    `bvh_builder` overrides the BVH build fn (e.g. the native C++ builder).
    """
    materials = list(materials)
    if not materials:
        materials = [Material.diffuse((0.8, 0.8, 0.8))]

    mat_color = np.array([m.color for m in materials], np.float32).reshape(-1, 3)
    mat_rough = np.array([m.roughness for m in materials], np.float32)
    mat_ior = np.array([m.ior for m in materials], np.float32)
    mat_type = np.array([m.mtype for m in materials], np.int32)

    S = len(spheres)
    sph_center = np.array([s.center for s in spheres], np.float32).reshape(S, 3)
    sph_radius = np.array([s.scale for s in spheres], np.float32)
    sph_mat = np.array([s.material_id for s in spheres], np.int32)
    sph_mtype = mat_type[sph_mat] if S else np.zeros((0,), np.int32)
    sph_ior = mat_ior[sph_mat] if S else np.zeros((0,), np.float32)

    # Merge meshes into one triangle soup.
    all_a, all_b, all_c, all_m = [], [], [], []
    for mesh in meshes:
        if mesh.num_triangles() == 0:
            continue
        p = mesh.positions
        idx = mesh.indices
        all_a.append(p[idx[:, 0]])
        all_b.append(p[idx[:, 1]])
        all_c.append(p[idx[:, 2]])
        all_m.append(mesh.tri_material)
    if all_a:
        A = np.concatenate(all_a)
        Bv = np.concatenate(all_b)
        C = np.concatenate(all_c)
        Mt = np.concatenate(all_m)
    else:
        A = Bv = C = np.zeros((0, 3), np.float32)
        Mt = np.zeros((0,), np.int32)

    e1 = Bv - A
    e2 = C - A
    n = np.cross(e1, e2)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(ln, 1e-30)

    tri_min = np.minimum(np.minimum(A, Bv), C)
    tri_max = np.maximum(np.maximum(A, Bv), C)
    builder = bvh_builder or accel.build_bvh
    bvh = builder(tri_min, tri_max, max_leaf_prims)
    if A.shape[0] > 0:
        perm = bvh.order
        A, e1, e2, n, Mt = A[perm], e1[perm], e2[perm], n[perm], Mt[perm]

    L = len(lights)
    light_pos = np.array([l.position for l in lights], np.float32).reshape(L, 3)
    light_hw = np.array([l.half_width for l in lights], np.float32)
    light_color = np.array([l.color for l in lights], np.float32).reshape(L, 3)
    light_intensity = np.array([l.intensity for l in lights], np.float32)
    light_temp = np.array([l.color_temp for l in lights], np.float32)
    light_type = np.array([l.ltype for l in lights], np.int32)
    light_normal = np.array([l.normal for l in lights], np.float32).reshape(L, 3)

    j = lambda x: jnp.asarray(x)
    return Scene(
        sph_center=j(sph_center), sph_radius=j(sph_radius), sph_mat=j(sph_mat),
        sph_mtype=j(sph_mtype), sph_ior=j(sph_ior),
        mat_color=j(mat_color), mat_rough=j(mat_rough),
        mat_ior=j(mat_ior), mat_type=j(mat_type),
        tri_a=j(A.astype(np.float32)), tri_e1=j(e1.astype(np.float32)),
        tri_e2=j(e2.astype(np.float32)), tri_n=j(n.astype(np.float32)),
        tri_mat=j(Mt),
        bvh_min=j(bvh.bbox_min), bvh_max=j(bvh.bbox_max),
        bvh_left=j(bvh.left), bvh_right=j(bvh.right),
        bvh_first=j(bvh.first), bvh_count=j(bvh.count),
        light_pos=j(light_pos), light_hw=j(light_hw), light_color=j(light_color),
        light_intensity=j(light_intensity), light_temp=j(light_temp),
        light_type=j(light_type), light_normal=j(light_normal),
        bvh_max_leaf=int(max(max_leaf_prims, int(bvh.count.max(initial=0)))),
    )


# ----- Stock scenes (the reference default + BASELINE.json presets) -----

def default_scene(obj_path: str | None = None) -> Scene:
    """The reference's hard-coded scene (ref: src/lib.rs:220-447): white
    ground sphere, green diffuse sphere, glass sphere, optional red OBJ mesh
    at (0,3,5) scale 0.5, one 5500K square area light at (10,3,0)."""
    materials = [
        Material.diffuse((0.8, 0.8, 0.8)),
        Material.diffuse((0.2, 0.85, 0.2)),
        Material.dielectric(1.5, 0.01),
        Material.diffuse((0.85, 0.2, 0.2)),
    ]
    spheres = [
        Sphere(1, 1.0, (0.0, 1.0, -1.0)),
        Sphere(0, 1000.0, (0.0, -1000.0, 0.0)),
        Sphere(2, 1.0, (0.0, 1.0, 1.0)),
    ]
    meshes = []
    if obj_path is not None:
        mesh = MeshData(material_id=3, translation=(0.0, 3.0, 5.0), scale=0.5)
        mesh.load_obj(obj_path)
        meshes.append(mesh)
    lights = [
        Light.square_area([10.0, 3.0, 0.0], [-1.0, 0.0, 0.0], 3.0,
                          [1.0, 1.0, 1.0], 1.0, 5500.0),
    ]
    return build_scene(materials, spheres, meshes, lights, max_leaf_prims=2)


def cornell_spheres_scene() -> Scene:
    """Cornell-box-style sphere scene — the BASELINE headline config
    (walls as giant spheres keep the hot loop sphere-only, as the metric
    "Mrays/sec at 1080p Cornell-box sphere scene" intends)."""
    materials = [
        Material.diffuse((0.73, 0.73, 0.73)),   # white
        Material.diffuse((0.65, 0.05, 0.05)),   # red
        Material.diffuse((0.12, 0.45, 0.15)),   # green
        Material.dielectric(1.5, 0.0),          # glass
        Material.dielectric(1.5, 0.04),         # frosted
    ]
    R = 1000.0
    box = 5.0
    spheres = [
        Sphere(0, R, (0.0, -R, 0.0)),          # floor
        Sphere(0, R, (0.0, R + 2 * box, 0.0)), # ceiling
        Sphere(0, R, (0.0, box, R + box)),     # back
        Sphere(1, R, (-R - box, box, 0.0)),    # left (red)
        Sphere(2, R, (R + box, box, 0.0)),     # right (green)
        Sphere(3, 1.5, (-1.8, 1.5, 1.0)),      # glass ball
        Sphere(4, 1.5, (1.8, 1.5, -0.5)),      # frosted ball
        Sphere(0, 1.0, (0.3, 1.0, 2.8)),       # small white
    ]
    lights = [
        Light.square_area([0.0, 2 * box - 0.01, 0.0], [0.0, -1.0, 0.0], 1.5,
                          [1.0, 1.0, 1.0], 6.0, 5500.0),
    ]
    return build_scene(materials, spheres, [], lights)


def instanced_scene(n_instances: int = 256, seed: int = 7) -> Scene:
    """>=256 sphere instances on a ground plane (BASELINE config 3)."""
    rng = np.random.default_rng(seed)
    materials = [
        Material.diffuse((0.75, 0.75, 0.75)),
        Material.diffuse((0.8, 0.3, 0.25)),
        Material.diffuse((0.25, 0.5, 0.85)),
        Material.dielectric(1.5, 0.0),
        Material.dielectric(1.5, 0.05),
        Material.diffuse((0.9, 0.75, 0.3)),
    ]
    spheres = [Sphere(0, 1000.0, (0.0, -1000.0, 0.0))]
    side = int(math.ceil(math.sqrt(n_instances)))
    for i in range(n_instances):
        gx, gz = i % side, i // side
        x = (gx - side / 2) * 2.2 + rng.uniform(-0.4, 0.4)
        z = (gz - side / 2) * 2.2 + rng.uniform(-0.4, 0.4) + 8.0
        r = rng.uniform(0.3, 0.8)
        mat = int(rng.integers(1, len(materials)))
        spheres.append(Sphere(mat, r, (x, r, z)))
    lights = [
        Light.square_area([0.0, 30.0, 8.0], [0.0, -1.0, 0.0], 8.0,
                          [1.0, 1.0, 1.0], 40.0, 6500.0),
    ]
    return build_scene(materials, spheres, [], lights)


def many_light_scene(n_lights: int = 16, seed: int = 11) -> Scene:
    """Cornell-style room lit by a grid of n_lights small area lights of
    very unequal power (plus the sphere props) — the many-light NEE
    stress scene for cfg.light_sample="power" (EXTENSION; the reference
    never exceeds one light). All-mode NEE cost grows O(n_lights) here;
    power mode stays O(1) shadow rays per bounce."""
    rng = np.random.default_rng(seed)
    materials = [
        Material.diffuse((0.73, 0.73, 0.73)),
        Material.diffuse((0.65, 0.05, 0.05)),
        Material.diffuse((0.12, 0.45, 0.15)),
        Material.dielectric(1.5, 0.0),
    ]
    R = 1000.0
    box = 5.0
    spheres = [
        Sphere(0, R, (0.0, -R, 0.0)),
        Sphere(0, R, (0.0, R + 2 * box, 0.0)),
        Sphere(0, R, (0.0, box, R + box)),
        Sphere(1, R, (-R - box, box, 0.0)),
        Sphere(2, R, (R + box, box, 0.0)),
        Sphere(3, 1.5, (-1.8, 1.5, 1.0)),
        Sphere(0, 1.2, (1.8, 1.2, -0.5)),
    ]
    side = int(math.ceil(math.sqrt(n_lights)))
    lights = []
    for i in range(n_lights):
        gx, gz = i % side, i // side
        x = (gx + 0.5) / side * 2 * (box - 0.5) - (box - 0.5)
        z = (gz + 0.5) / side * 2 * (box - 0.5) - (box - 0.5)
        # log-uniform power spread: selection has real work to do
        inten = float(10.0 ** rng.uniform(-1.0, 1.0))
        col = tuple(float(c) for c in rng.uniform(0.3, 1.0, 3))
        lights.append(Light.square_area(
            [x, 2 * box - 0.01, z], [0.0, -1.0, 0.0],
            float(rng.uniform(0.2, 0.6)), col, inten,
            float(rng.uniform(2500.0, 6500.0))))
    return build_scene(materials, spheres, [], lights)


def dispersive_scene() -> Scene:
    """Dispersive glass + metal materials (BASELINE config 4)."""
    materials = [
        Material.diffuse((0.8, 0.8, 0.8)),
        Material.dielectric(1.52, 0.0),    # crown-glass ball (dispersive)
        Material.dielectric(1.72, 0.0),    # dense flint
        Material.metal((1.0, 0.71, 0.29), 0.05),  # brushed gold
        Material.diffuse((0.3, 0.3, 0.8)),
    ]
    spheres = [
        Sphere(0, 1000.0, (0.0, -1000.0, 0.0)),
        Sphere(1, 1.0, (-2.2, 1.0, 4.0)),
        Sphere(2, 1.0, (0.0, 1.0, 4.5)),
        Sphere(3, 1.0, (2.2, 1.0, 4.0)),
        Sphere(4, 0.7, (0.0, 0.7, 7.0)),
    ]
    lights = [
        Light.point([0.0, 8.0, 0.0], [1.0, 1.0, 1.0], 60.0, 5500.0),
        Light.square_area([6.0, 4.0, 4.0], [-1.0, -0.3, 0.0], 2.0,
                          [1.0, 1.0, 1.0], 4.0, 3200.0),
    ]
    return build_scene(materials, spheres, [], lights)


def torus_mesh_scene(nu: int = 16, nv: int = 8) -> Scene:
    """Procedural 2*nu*nv-triangle torus mesh + two glass spheres on a
    ground sphere — the mesh-at-scale demo scene (exercises the triangle
    cull tree; 256 triangles by default). Outward winding: the integrator
    shades the geometric normal single-sided like the reference."""
    R0, r0 = 1.6, 0.55
    verts = np.empty((nu * nv, 3), np.float32)
    for i in range(nu):
        for j in range(nv):
            u = 2.0 * math.pi * i / nu
            v = 2.0 * math.pi * j / nv
            verts[i * nv + j] = ((R0 + r0 * math.cos(v)) * math.cos(u),
                                 r0 * math.sin(v) + r0 + 1.0,
                                 (R0 + r0 * math.cos(v)) * math.sin(u))
    faces = []
    for i in range(nu):
        for j in range(nv):
            a = i * nv + j
            b = ((i + 1) % nu) * nv + j
            c = ((i + 1) % nu) * nv + (j + 1) % nv
            d = i * nv + (j + 1) % nv
            faces.append((a, c, b))
            faces.append((a, d, c))
    mesh = MeshData(material_id=2, translation=(0.0, 0.0, 6.0))
    mesh.add_triangles(verts, np.asarray(faces, np.int32))
    materials = [
        Material.diffuse((0.75, 0.75, 0.75)),
        Material.dielectric(1.5, 0.0),
        Material.diffuse((0.85, 0.25, 0.2)),
    ]
    spheres = [Sphere(0, 1000.0, (0.0, -1000.0, 0.0)),
               Sphere(1, 0.9, (-2.6, 0.9, 4.2)),
               Sphere(1, 0.9, (2.6, 0.9, 4.2))]
    lights = [Light.square_area([3, 8, 2], [-0.4, -1.0, 0.3], 2.5,
                                [1.0, 1.0, 1.0], 6.0, 5000.0)]
    return build_scene(materials, spheres, [mesh], lights)


def torus_field_scene(n_tori: int = 16, nu: int = 45, nv: int = 45,
                      seed: int = 5) -> Scene:
    """n_tori tori of 2*nu*nv triangles each, spread over the ground plane
    (default 16 x 4050 = 64,800 triangles) — the spatially-distributed
    big-mesh scene for chunked-walk benchmarks (bench config 7). A tile's
    ray beam crosses 1-2 tori, so the coarse chunk tree prunes the rest;
    contrast with torus_mesh_scene(180,180), the same triangle count in
    ONE frustum-filling object, where every beam must sweep its full
    local tessellation (the measured worst case, README scale table)."""
    rng = np.random.default_rng(seed)
    R0, r0 = 1.6, 0.55
    verts = np.empty((nu * nv, 3), np.float32)
    for i in range(nu):
        for j in range(nv):
            u = 2.0 * math.pi * i / nu
            v = 2.0 * math.pi * j / nv
            verts[i * nv + j] = ((R0 + r0 * math.cos(v)) * math.cos(u),
                                 r0 * math.sin(v) + r0 + 1.0,
                                 (R0 + r0 * math.cos(v)) * math.sin(u))
    faces = []
    for i in range(nu):
        for j in range(nv):
            a = i * nv + j
            b = ((i + 1) % nu) * nv + j
            c = ((i + 1) % nu) * nv + (j + 1) % nv
            d = i * nv + (j + 1) % nv
            faces.append((a, c, b))
            faces.append((a, d, c))
    faces = np.asarray(faces, np.int32)
    materials = [
        Material.diffuse((0.75, 0.75, 0.75)),
        Material.dielectric(1.5, 0.0),
        Material.diffuse((0.85, 0.25, 0.2)),
        Material.diffuse((0.25, 0.45, 0.8)),
        Material.metal((0.95, 0.75, 0.35), 0.05),
    ]
    meshes = []
    side = int(math.ceil(math.sqrt(n_tori)))
    for t in range(n_tori):
        gx, gz = t % side, t // side
        x = (gx - (side - 1) / 2) * 7.0 + rng.uniform(-1.0, 1.0)
        z = (gz - (side - 1) / 2) * 7.0 + 10.0 + rng.uniform(-1.0, 1.0)
        mesh = MeshData(material_id=int(rng.integers(2, len(materials))),
                        translation=(x, 0.0, z),
                        rotation_deg=float(rng.uniform(0.0, 360.0)))
        mesh.add_triangles(verts, faces)
        meshes.append(mesh)
    spheres = [Sphere(0, 1000.0, (0.0, -1000.0, 0.0)),
               Sphere(1, 0.9, (0.0, 0.9, 2.0))]
    lights = [Light.square_area([0, 22, 10], [0.0, -1.0, 0.0], 6.0,
                                [1.0, 1.0, 1.0], 25.0, 5500.0)]
    return build_scene(materials, spheres, meshes, lights)


def tri_test_scene() -> Scene:
    """Small mesh scene used by tests: two-triangle quad + one sphere."""
    materials = [
        Material.diffuse((0.8, 0.8, 0.8)),
        Material.diffuse((0.85, 0.2, 0.2)),
    ]
    mesh = MeshData(material_id=1)
    quad_pos = np.array([
        [-1.0, 0.0, 3.0], [1.0, 0.0, 3.0], [1.0, 2.0, 3.0], [-1.0, 2.0, 3.0],
    ], np.float32)
    quad_idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    mesh.add_triangles(quad_pos, quad_idx)
    spheres = [Sphere(0, 1000.0, (0.0, -1000.5, 0.0))]
    lights = [Light.point([0.0, 5.0, 0.0], [1.0, 1.0, 1.0], 10.0, 5500.0)]
    return build_scene(materials, spheres, [mesh], lights)
