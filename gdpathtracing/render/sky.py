"""Sky radiance: analytic gradient (main.glsl:189-192) or an equirect
HDRI environment map (reference wishlist "Sky HDRI", README.md:37)."""

from __future__ import annotations

import jax.numpy as jnp

from gdpathtracing.config import RenderConfig
from gdpathtracing.core.vec import Vec3, lerp

PI = 3.141592653589793


def sample_sky(direction: Vec3, config: RenderConfig,
               scene=None) -> Vec3:
    if scene is not None and getattr(scene, "has_env", False):
        return sample_environment(scene.env_map, direction) * \
            scene.env_energy
    t = 0.5 * (direction.y + 1.0)
    return lerp(Vec3(*config.sky_horizon), Vec3(*config.sky_zenith), t)


def sample_environment(env: jnp.ndarray, d: Vec3) -> Vec3:
    """Bilinear equirect lookup: u from atan2(x, -z), v from acos(y)."""
    h, w = env.shape[0], env.shape[1]
    u = jnp.arctan2(d.x, -d.z) / (2.0 * PI) + 0.5
    v = jnp.arccos(jnp.clip(d.y, -1.0, 1.0)) / PI
    fu = u * w - 0.5
    fv = v * h - 0.5
    x0 = jnp.floor(fu).astype(jnp.int32)
    y0 = jnp.floor(fv).astype(jnp.int32)
    fx = fu - x0
    fy = fv - y0
    x0w = x0 % w
    x1w = (x0 + 1) % w
    y0c = jnp.clip(y0, 0, h - 1)
    y1c = jnp.clip(y0 + 1, 0, h - 1)

    def fetch(yy, xx):
        c = env[yy, xx]
        return Vec3(c[..., 0], c[..., 1], c[..., 2])

    top = fetch(y0c, x0w) + (fetch(y0c, x1w) - fetch(y0c, x0w)) * fx
    bot = fetch(y1c, x0w) + (fetch(y1c, x1w) - fetch(y1c, x0w)) * fx
    return top + (bot - top) * fy
