"""tpurt — a progressive spectral path tracer in JAX / Pallas.

A ground-up rebuild of the capability surface of elieseek/wgpu-raytracer
(Rust + WGSL, wgpu compute) as an idiomatic JAX library: pure-functional
scene pytrees, masked lockstep integrators under jit, Pallas pixel-tile
megakernels, and shard_map pixel-sharding for multi-chip scaling.

Layer map (mirrors SURVEY.md §1, redesigned for array accelerators):
  app/interaction   tpurt.viewer       (progressive loop + camera controller)
  scene (host)      tpurt.scene, tpurt.camera, tpurt.accel, tpurt.utils.obj
  pass orchestration tpurt.render      (RenderState pytree, jitted steps)
  device kernels    tpurt.integrate (XLA), tpurt.kernels.* (Pallas)
  runtime           XLA:GPU via jax (tpurt.runtime); tpurt.parallel for
                    device meshes
"""

from tpurt.camera import Camera, CameraController, make_camera, set_vfov
from tpurt.config import RenderConfig
from tpurt.render import (
    RenderState,
    init_state,
    load_checkpoint,
    render,
    render_step,
    render_until,
    resolve_image,
    resolve_radiance,
    save_checkpoint,
)
from tpurt.wavefront import WavefrontPool, wavefront_render
from tpurt.adaptive import render_adaptive, wavefront_render_budget
from tpurt.denoise import atrous_denoise, denoise_image, render_aovs
from tpurt.query import RayHits, light_probe, occlusion, trace_rays
from tpurt.scene import (
    Light,
    Material,
    MeshData,
    Scene,
    Sphere,
    build_scene,
    cornell_spheres_scene,
    default_scene,
    dispersive_scene,
    instanced_scene,
    many_light_scene,
    torus_field_scene,
    torus_mesh_scene,
)

__version__ = "0.1.0"

__all__ = [
    "Camera", "CameraController", "make_camera", "set_vfov",
    "RenderConfig", "RenderState",
    "init_state", "render", "render_step", "render_until", "resolve_image",
    "resolve_radiance",
    "save_checkpoint", "load_checkpoint",
    "Light", "Material", "MeshData", "Scene", "Sphere",
    "build_scene", "cornell_spheres_scene", "default_scene",
    "dispersive_scene", "instanced_scene", "many_light_scene",
    "torus_field_scene",
    "torus_mesh_scene",
    "WavefrontPool", "wavefront_render",
    "render_adaptive", "wavefront_render_budget",
    "atrous_denoise", "denoise_image", "render_aovs",
    "RayHits", "light_probe", "occlusion", "trace_rays",
]
