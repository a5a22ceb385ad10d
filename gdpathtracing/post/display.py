"""Display transform: exposure → bloom → tonemap.

Reference wishlist item "Simple post processing (e.g. bloom, controllable
tone-mapping)" (README.md:38): the reference hard-codes ACES with exposure
1.0 (progressive_rendering.glsl:41-43); here the operator, exposure, and a
separable-Gaussian bloom are RenderConfig fields.
"""

from __future__ import annotations

import jax.numpy as jnp

from gdpathtracing.config import RenderConfig, Tonemap
from gdpathtracing.post.tonemap import aces_film


def bloom(img: jnp.ndarray, threshold: float, strength: float,
          radius: int) -> jnp.ndarray:
    """Threshold the highlights, blur with a separable Gaussian, add back."""
    bright = jnp.maximum(img - threshold, 0.0)
    sigma = max(radius / 2.0, 1e-3)
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    # separable blur via padded correlation along H then W
    def blur_axis(a, axis):
        pad = [(0, 0)] * a.ndim
        pad[axis] = (radius, radius)
        ap = jnp.pad(a, pad, mode="edge")
        out = jnp.zeros_like(a)
        for i in range(2 * radius + 1):
            sl = [slice(None)] * a.ndim
            sl[axis] = slice(i, i + a.shape[axis])
            out = out + k[i] * ap[tuple(sl)]
        return out

    blurred = blur_axis(blur_axis(bright, 0), 1)
    return img + strength * blurred


def display_transform(linear: jnp.ndarray,
                      config: RenderConfig) -> jnp.ndarray:
    """(H, W, 3) linear radiance → display [0, 1]."""
    img = linear * config.exposure
    if config.bloom:
        img = bloom(img, config.bloom_threshold, config.bloom_strength,
                    config.bloom_radius)
    if config.tonemap == Tonemap.ACES:
        return aces_film(img)
    if config.tonemap == Tonemap.REINHARD:
        return jnp.clip(img / (1.0 + img), 0.0, 1.0)
    return jnp.clip(img, 0.0, 1.0)  # LINEAR
