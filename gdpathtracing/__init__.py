"""gdpathtracing — a differentiable path tracing framework in JAX.

Built from scratch in JAX/Pallas with the capabilities of the Godot GDExtension
plugin JorisAR/GDPathTracing (reference layer map in SURVEY.md §1):

- ``scene``   — scene compilation: OBJ loading, material/texture flattening
                (analog of reference src/path_tracing/geometry_group3d.*)
- ``bvh``     — binned-SAH BLAS + agglomerative TLAS builders emitting flat
                device arrays (analog of reference src/bvh/*)
- ``render``  — camera, ray generation, BVH traversal, BRDFs, path integrator
                (analog of reference shaders/main.glsl + brdfs.glsl)
- ``post``    — progressive accumulation, temporal reprojection, ACES tonemap
                (analog of reference src/path_tracing/post_processing/*)
- ``parallel``— multi-chip sharding of the ray wavefront over a device mesh
                (new capability; no reference counterpart — SURVEY.md §2 end)
- ``diff``    — differentiable rendering utilities (new capability)
- ``ops``     — the Pallas trace kernel (Triton route on the GPU)

The reference's L2 "ComputeShader" GPU-orchestration layer (SURVEY.md §2.7)
dissolves here: XLA owns buffers and dispatch; its analog is the jitted render
step in :mod:`gdpathtracing.render.engine`.
"""

from gdpathtracing.config import RenderConfig, DenoisingMode
from gdpathtracing.scene.scene import Scene, SceneBuilder
from gdpathtracing.scene.materials import Material
from gdpathtracing.render.camera import Camera
from gdpathtracing.render.renderer import render, render_frame
from gdpathtracing.render.engine import Engine

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "DenoisingMode",
    "Scene",
    "SceneBuilder",
    "Material",
    "Camera",
    "render",
    "render_frame",
    "Engine",
]
