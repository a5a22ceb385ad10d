"""Differentiable / inverse rendering (BASELINE config 4 — a capability the
reference does not have).

The integrator is written to be differentiable end-to-end: sampling
decisions and pdfs are detached (render/integrator.py), so
``jax.grad`` of any pixel functional w.r.t. scene parameters — material
albedo/emission/roughness, albedo textures, triangle vertices, camera
pose — yields the standard interior-derivative estimator. Visibility
(silhouette) discontinuities are NOT differentiated yet; gradients are
exact for parameters that do not move silhouettes (albedo, emission,
textures) and biased near silhouettes for geometry/camera.

``apply_fn``-style parameterization: a pure function
``(base_scene_or_camera, params) -> scene/camera`` defines WHAT is being
optimized; this module provides the common ones.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

from gdpathtracing.config import RenderConfig
from gdpathtracing.render.camera import Camera
from gdpathtracing.render.renderer import render_radiance
from gdpathtracing.scene.scene import Scene


# ---- parameterizations ----

def replace_albedo(scene: Scene, albedo: jnp.ndarray) -> Scene:
    return dataclasses.replace(scene, mat_albedo=albedo)


def replace_emission(scene: Scene, emission: jnp.ndarray) -> Scene:
    return dataclasses.replace(scene, mat_emission=emission)


def replace_vertices(scene: Scene, tri_pos: jnp.ndarray) -> Scene:
    """Deform vertices AND rebuild the derived device tables in-graph
    (BLAS refit, world-space unit-triangle tables, chunk AABBs, TLAS) via
    scene.dynamic.update_vertices. This is what makes vertex gradients flow
    through the fast path: trace_pallas_diff recomputes the hit from
    ``scene.isect_cols``, which here is a differentiable function of
    ``tri_pos`` (previously the tables were the stale
    NumPy build-time ones and the PALLAS vertex gradient was zero)."""
    from gdpathtracing.scene.dynamic import update_vertices
    return update_vertices(scene, tri_pos)


def replace_instance_transforms(scene: Scene,
                                transforms: jnp.ndarray) -> Scene:
    """Re-pose instances ((I, 3, 4) affines) with the full in-graph table
    rebuild — gradients w.r.t. rigid/affine instance motion flow through
    the fast path the same way as replace_vertices."""
    from gdpathtracing.scene.dynamic import update_instance_transforms
    return update_instance_transforms(scene, transforms)


def replace_textures(scene: Scene, textures: jnp.ndarray) -> Scene:
    return dataclasses.replace(scene, textures=textures)


def replace_camera_transform(camera: Camera, transform: jnp.ndarray) -> Camera:
    return dataclasses.replace(camera, transform=transform)


# ---- losses ----

def image_mse(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.mean((a - b) ** 2)


def render_loss(params, apply_scene: Callable[[Scene, object], Scene],
                base_scene: Scene, camera: Camera, config: RenderConfig,
                target: jnp.ndarray, frame_index=0,
                apply_camera: Callable[[Camera, object], Camera] | None = None):
    """MSE between a render under `params` and `target`. `params` may feed
    the scene, the camera, or both (pass a (scene_p, cam_p) tuple and both
    apply fns)."""
    if apply_camera is not None:
        scene_p, cam_p = params
        scene = apply_scene(base_scene, scene_p)
        camera = apply_camera(camera, cam_p)
    else:
        scene = apply_scene(base_scene, params)
    aovs = render_radiance(scene, camera, config, frame_index)
    return image_mse(aovs.radiance, target)


def unbiased_mse_value_and_grad(params, apply_scene, base_scene: Scene,
                                camera: Camera, config: RenderConfig,
                                target: jnp.ndarray, frame_a, frame_b):
    """Decorrelated MSE gradient — the unbiased estimator for Monte-Carlo
    inverse rendering.

    With a single sample set, ∇E[(X−T)²] picks up E[(X−E[X])∇X] — a
    variance-reduction term that drags parameters toward low-variance (not
    correct) configurations. Using independent seeds for the residual
    (frame_a) and the differentiated render (frame_b) removes it:
    grad = (2/N)·⟨X_a − T, ∇X_b⟩, E[grad] = ∇‖E[X]−T‖².
    """
    def render_fn(p, frame):
        scene = apply_scene(base_scene, p)
        return render_radiance(scene, camera, config, frame).radiance

    x_a = jax.lax.stop_gradient(render_fn(params, frame_a))
    residual = 2.0 * (x_a - target) / x_a.size
    _, vjp = jax.vjp(lambda p: render_fn(p, frame_b), params)
    (grad,) = vjp(residual)
    loss = jnp.mean((x_a - target) ** 2)
    return loss, grad


def value_and_grad_step(apply_scene, config: RenderConfig,
                        apply_camera=None):
    """Returns a jittable fn(params, base_scene, camera, target,
    frame_index) -> (loss, grads). Gradients average over the pixel
    estimator; under a device mesh the psum over chips is inserted by XLA
    automatically (parallel/sharding.py notes)."""

    def fn(params, base_scene, camera, target, frame_index=0):
        return jax.value_and_grad(render_loss)(
            params, apply_scene, base_scene, camera, config, target,
            frame_index, apply_camera)

    return fn
