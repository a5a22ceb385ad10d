"""Core SoA ray/hit/shading records (pytrees).

Analogs of the reference GLSL structs Ray / HitInfo / ShadingInfo
(main.glsl:26-82), but as structure-of-arrays NamedTuples over ``(N,)``
component arrays — one record *is* the whole wavefront.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from gdpathtracing.core.vec import Vec3


class Ray(NamedTuple):
    o: Vec3
    d: Vec3

    def rcp_d(self, eps: float = 0.0) -> Vec3:
        """1/d as in main.glsl:421 (GLSL 1/0 = inf is fine; XLA matches)."""
        return Vec3(1.0 / self.d.x, 1.0 / self.d.y, 1.0 / self.d.z)

    def at(self, t) -> Vec3:
        return self.o + self.d * t


MISS_T = np.float32(1e9)  # main.glsl:354 (np scalar: no backend init at import)


class HitInfo(NamedTuple):
    """Closest-hit record (t in instance-invariant units: directions are
    transformed into object space WITHOUT renormalizing — main.glsl:320 —
    so t compares across instances)."""

    t: jnp.ndarray       # f32, 1e9 = miss
    tri: jnp.ndarray     # i32 triangle index (global pool)
    inst: jnp.ndarray    # i32 BLAS-instance index
    u: jnp.ndarray       # f32 barycentric
    v: jnp.ndarray       # f32 barycentric
    front: jnp.ndarray   # bool — geometric normal faces the ray
    steps: jnp.ndarray   # i32 — triangle tests (DEBUG_STEPS analog)
    eidx: jnp.ndarray    # i32 — expanded-triangle index (-1 when the
    #                      backend doesn't track it; enables the packed
    #                      fast shading fetch)

    @classmethod
    def none(cls, shape) -> "HitInfo":
        z = jnp.zeros(shape, dtype=jnp.float32)
        zi = jnp.zeros(shape, dtype=jnp.int32)
        return cls(t=jnp.full(shape, MISS_T, dtype=jnp.float32),
                   tri=zi, inst=zi, u=z, v=z,
                   front=jnp.zeros(shape, dtype=bool), steps=zi,
                   eidx=zi - 1)

    @classmethod
    def none_like(cls, ref: jnp.ndarray) -> "HitInfo":
        """Miss record derived arithmetically from `ref` so it inherits
        ref's varying-axes type — required for loop carries under
        shard_map (constants would be replicated-typed and mismatch)."""
        z = ref * 0.0
        zi = z.astype(jnp.int32)
        return cls(t=z + MISS_T, tri=zi, inst=zi, u=z, v=z,
                   front=zi.astype(bool), steps=zi, eidx=zi - 1)

    @property
    def hit(self) -> jnp.ndarray:
        return self.t < MISS_T


class ShadingInfo(NamedTuple):
    """Analog of main.glsl:73-82 ShadingInfo (+ dielectric transmission,
    which the reference lists as a wishlist item)."""

    position: Vec3
    normal: Vec3
    out_dir: Vec3
    lambert_out: jnp.ndarray
    emission: Vec3
    diffuse_albedo: Vec3
    fresnel_0: Vec3
    roughness: jnp.ndarray
    transmission: jnp.ndarray   # dielectric transparency in [0, 1]
    ior: jnp.ndarray
    albedo: Vec3                # untinted base color (transmission tint)
