"""Camera: pose, projection, and primary-ray generation.

Analog of the reference Camera UBO + matrix composition
(render_parameters.h:14-47: vp = projection * affine_inverse(model)) and of
the primary-ray block of the megakernel (main.glsl:405-421). The camera
transform and FOV are pytree leaves, so gradients flow to camera pose
(a BASELINE.json target the reference cannot do).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from gdpathtracing.config import Jitter, RenderConfig
from gdpathtracing.core import rng
from gdpathtracing.core.math3d import look_at
from gdpathtracing.core.vec import Vec3
from gdpathtracing.render.types import Ray

_TWO_PI = 6.2831853


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Camera:
    """World-from-camera affine (3,4) + intrinsics. width/height are static
    metadata (resolution is a property of the camera, as in the reference:
    path_tracing_camera.cpp:124)."""

    transform: jnp.ndarray          # (3, 4) f32, camera looks down -Z
    fov_deg: jnp.ndarray            # () f32 vertical FOV
    width: int = dataclasses.field(metadata=dict(static=True), default=640)
    height: int = dataclasses.field(metadata=dict(static=True), default=360)
    near: float = dataclasses.field(metadata=dict(static=True), default=0.01)
    far: float = dataclasses.field(metadata=dict(static=True), default=1000.0)

    # ---- constructors ----
    @classmethod
    def from_affine(cls, transform, fov_deg: float, width: int, height: int,
                    near: float = 0.01, far: float = 1000.0) -> "Camera":
        return cls(jnp.asarray(transform, dtype=jnp.float32),
                   jnp.asarray(fov_deg, dtype=jnp.float32),
                   width, height, near, far)

    @classmethod
    def looking_at(cls, eye, target, up=(0.0, 1.0, 0.0), *, fov_deg: float,
                   width: int, height: int, near: float = 0.01,
                   far: float = 1000.0) -> "Camera":
        return cls.from_affine(look_at(eye, target, up), fov_deg,
                               width, height, near, far)

    # ---- derived matrices (jnp: differentiable w.r.t. transform/fov) ----
    @property
    def position(self) -> Vec3:
        return Vec3(self.transform[0, 3], self.transform[1, 3],
                    self.transform[2, 3])

    @property
    def aspect(self) -> float:
        return self.width / self.height

    def projection(self) -> jnp.ndarray:
        """GL-style perspective (matches math3d.perspective; Godot
        Projection::create_perspective as used at
        path_tracing_camera.cpp:134)."""
        f = 1.0 / jnp.tan(jnp.radians(self.fov_deg) * 0.5)
        n, fa = self.near, self.far
        zero = jnp.zeros_like(f)
        one = jnp.ones_like(f)
        return jnp.array(
            [[f / self.aspect, zero, zero, zero],
             [zero, f, zero, zero],
             [zero, zero, (fa + n) / (n - fa) * one, 2 * fa * n / (n - fa) * one],
             [zero, zero, -one, zero]], dtype=jnp.float32)

    def view(self) -> jnp.ndarray:
        """Camera-from-world 4x4 = affine inverse of `transform`.

        All small matmuls here run at float32 precision: a reduced-
        precision default (TF32 on the GPU) destroys the near/far
        cancellation in these matrices and NaNs the un-projection."""
        with jax.default_matmul_precision("float32"):
            r = self.transform[:, :3]
            t = self.transform[:, 3]
            r_inv = jnp.linalg.inv(r)
            m = jnp.eye(4, dtype=jnp.float32)
            m = m.at[:3, :3].set(r_inv)
            m = m.at[:3, 3].set(-r_inv @ t)
            return m

    def vp(self) -> jnp.ndarray:
        with jax.default_matmul_precision("float32"):
            return self.projection() @ self.view()

    def ivp(self) -> jnp.ndarray:
        """Analytic inverse: world-from-camera @ P⁻¹ (closed form — avoids
        inverting the catastrophically-conditioned vp product)."""
        f = 1.0 / jnp.tan(jnp.radians(self.fov_deg) * 0.5)
        n, fa = self.near, self.far
        a = (fa + n) / (n - fa)
        b = 2.0 * fa * n / (n - fa)
        zero = jnp.zeros_like(f)
        one = jnp.ones_like(f)
        p_inv = jnp.array(
            [[self.aspect / f, zero, zero, zero],
             [zero, 1.0 / f, zero, zero],
             [zero, zero, zero, -one],
             [zero, zero, one / b, a / b * one]], dtype=jnp.float32)
        t4 = jnp.concatenate(
            [self.transform,
             jnp.array([[0.0, 0.0, 0.0, 1.0]], dtype=jnp.float32)], axis=0)
        with jax.default_matmul_precision("float32"):
            return t4 @ p_inv

    # ---- ray generation (main.glsl:405-421) ----
    def generate_rays(self, pixel_ids: jnp.ndarray, seed, config: RenderConfig):
        """Primary rays for flat pixel indices (row-major). Returns
        (Ray, new_seed)."""
        px = (pixel_ids % self.width).astype(jnp.float32)
        py = (pixel_ids // self.width).astype(jnp.float32)

        (r1, r2), seed = rng.pcg2d(seed)
        if config.jitter == Jitter.NONE:
            jx = jy = jnp.zeros_like(px)
        elif config.jitter == Jitter.UNIFORM:
            jx, jy = r1 - 0.5, r2 - 0.5
        elif config.jitter == Jitter.GAUSS:
            # Proper Box–Muller (the reference drops the radius term,
            # main.glsl:183-187 — fixed here).
            radius = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(r1, 1e-10))) * 0.375
            theta = _TWO_PI * r2
            jx, jy = radius * jnp.cos(theta), radius * jnp.sin(theta)
        else:  # CIRCLE — reference-compatible unit-circle jitter
            theta = _TWO_PI * r2
            jx, jy = jnp.cos(theta), jnp.sin(theta)

        sx = (px + 0.5 + jx) / self.width * 2.0 - 1.0
        sy = (py + 0.5 + jy) / self.height * 2.0 - 1.0
        # Direct pinhole unprojection — algebraically identical to the
        # reference's ivp route (main.glsl:411-414) for this projection,
        # but with no catastrophic near/far cancellation (which a TF32
        # matmul turns into NaNs) and no matrix round-trip.
        half_tan = jnp.tan(jnp.radians(self.fov_deg) * 0.5)
        cx = sx * (half_tan * self.aspect)
        cy = -sy * half_tan
        cz = -jnp.ones_like(sx)  # camera looks down -Z
        m = self.transform
        d = Vec3(m[0, 0] * cx + m[0, 1] * cy + m[0, 2] * cz,
                 m[1, 0] * cx + m[1, 1] * cy + m[1, 2] * cz,
                 m[2, 0] * cx + m[2, 1] * cy + m[2, 2] * cz).normalize()
        pos = self.position
        # Tie the origin to d's varying-axes type (+ d*0): under shard_map
        # the camera is replicated but rays are sharded; a plain broadcast
        # would make `o` replicated-typed and break downstream loop carries.
        o = Vec3(pos.x + d.x * 0.0, pos.y + d.y * 0.0, pos.z + d.z * 0.0)
        return Ray(o=o, d=d), seed
