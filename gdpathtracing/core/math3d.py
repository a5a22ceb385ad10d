"""Host/device 3D transform helpers.

Replaces the reference's Utils::transform_to_float / projection math
(src/utils.h:15-49) and the Camera matrix composition
(src/path_tracing/render_parameters.h:23-38).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from gdpathtracing.core.vec import Vec3


def perspective(fov_y_deg: float, aspect: float, near: float, far: float) -> np.ndarray:
    """GL-style perspective projection (NDC z in [-1, 1], looking down -Z).

    Matches Godot Projection::create_perspective as used at
    path_tracing_camera.cpp:134. The integrator only ever uses vp together
    with its own inverse (main.glsl:411-414), so any self-consistent
    convention reproduces the reference's ray distribution.
    """
    f = 1.0 / np.tan(np.radians(fov_y_deg) * 0.5)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2.0 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """World-from-camera affine (3x4): camera looks down -Z at `target`."""
    eye = np.asarray(eye, dtype=np.float32)
    fwd = np.asarray(target, dtype=np.float32) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, dtype=np.float32))
    right /= np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    m = np.zeros((3, 4), dtype=np.float32)
    m[:, 0] = right
    m[:, 1] = true_up
    m[:, 2] = -fwd
    m[:, 3] = eye
    return m


def affine_inverse(m: np.ndarray) -> np.ndarray:
    """Inverse of a 3x4 affine (general, handles non-uniform scale/shear)."""
    m = np.asarray(m, dtype=np.float32)
    r_inv = np.linalg.inv(m[:, :3])
    out = np.zeros((3, 4), dtype=np.float32)
    out[:, :3] = r_inv
    out[:, 3] = -r_inv @ m[:, 3]
    return out


def affine_to_mat4(m: np.ndarray) -> np.ndarray:
    out = np.eye(4, dtype=np.float32)
    out[:3, :] = m
    return out


def affine_apply_point(m: jnp.ndarray, p: Vec3) -> Vec3:
    """Apply affine `m` of shape (..., 3, 4) (gathered per-ray or scalar)
    to points."""
    return Vec3(
        m[..., 0, 0] * p.x + m[..., 0, 1] * p.y + m[..., 0, 2] * p.z + m[..., 0, 3],
        m[..., 1, 0] * p.x + m[..., 1, 1] * p.y + m[..., 1, 2] * p.z + m[..., 1, 3],
        m[..., 2, 0] * p.x + m[..., 2, 1] * p.y + m[..., 2, 2] * p.z + m[..., 2, 3],
    )


def affine_apply_dir(m: jnp.ndarray, d: Vec3) -> Vec3:
    """Apply the linear part of affine `m` (..., 3, 4) to directions."""
    return Vec3(
        m[..., 0, 0] * d.x + m[..., 0, 1] * d.y + m[..., 0, 2] * d.z,
        m[..., 1, 0] * d.x + m[..., 1, 1] * d.y + m[..., 1, 2] * d.z,
        m[..., 2, 0] * d.x + m[..., 2, 1] * d.y + m[..., 2, 2] * d.z,
    )


def mat4_apply(m: jnp.ndarray, v4: tuple) -> tuple:
    """Apply a (4,4) matrix to a 4-tuple of component arrays."""
    x, y, z, w = v4
    return (
        m[0, 0] * x + m[0, 1] * y + m[0, 2] * z + m[0, 3] * w,
        m[1, 0] * x + m[1, 1] * y + m[1, 2] * z + m[1, 3] * w,
        m[2, 0] * x + m[2, 1] * y + m[2, 2] * z + m[2, 3] * w,
        m[3, 0] * x + m[3, 1] * y + m[3, 2] * z + m[3, 3] * w,
    )
