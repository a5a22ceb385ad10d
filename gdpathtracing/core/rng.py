"""PCG2D counter-based RNG, vectorized over uint32 arrays.

Bit-exact re-expression of the reference's shader RNG
(main.glsl:163-181, citing JCGT "Hash Functions for GPU Rendering").
Each ray carries a 2x uint32 seed; every draw advances the state and yields
two floats in [0, 1). Being counter-ish and stateless-per-ray, it is the
natural wavefront RNG: no cross-lane state, fully vectorized, identical
results regardless of sharding (per-ray streams are keyed by (pixel, frame)).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

# numpy scalars: importing this module must not initialize a JAX backend
_A = np.uint32(1664525)
_C = np.uint32(1013904223)
_GOLDEN = np.uint32(0x9E3779B9)
_INV32 = np.float32(2.32830643654e-10)  # 2^-32, constant from main.glsl:173


def pcg2d(seed: Tuple[jnp.ndarray, jnp.ndarray]):
    """One PCG2D step. Returns ((u, v) floats in [0,1), new_seed).

    Matches main.glsl:163-174 exactly (same constants, op order, and
    sequential component updates).
    """
    sx, sy = seed
    sx = sx * _A + _C
    sy = sy * _A + _C
    sx = sx + sy * _A
    sy = sy + sx * _A
    sx = sx ^ (sx >> 16)
    sy = sy ^ (sy >> 16)
    sx = sx + sy * _A
    sy = sy + sx * _A
    sx = sx ^ (sx >> 16)
    sy = sy ^ (sy >> 16)
    u = sx.astype(jnp.float32) * _INV32
    v = sy.astype(jnp.float32) * _INV32
    return (u, v), (sx, sy)


def prng_seed(px: jnp.ndarray, py: jnp.ndarray, frame) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-pixel seed hash — main.glsl:176-181.

    `px`, `py` are integer pixel coordinates (any int dtype), `frame` the
    frame counter.
    """
    frame = jnp.uint32(frame) if not hasattr(frame, "dtype") else frame.astype(jnp.uint32)
    sx = px.astype(jnp.uint32) * _GOLDEN + frame
    sy = py.astype(jnp.uint32) * _GOLDEN + frame
    sx = sx ^ (sx >> 16)
    sy = sy ^ (sy >> 16)
    return sx * _GOLDEN, sy * _GOLDEN
