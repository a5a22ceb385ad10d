"""Structure-of-arrays 3-vector math.

Replacement for the reference's AoS vec library (src/bvh/vec.h:11-215).
Storing points as ``(N, 3)`` arrays would give every elementwise op a
3-wide minor dimension; a :class:`Vec3` is instead a NamedTuple of three
``(N,)`` (or scalar) arrays — every arithmetic op is a contiguous full-width
vector op, and the layout maps directly onto Pallas kernel refs.

``Vec3`` is automatically a JAX pytree (NamedTuple), so it passes freely
through ``jit`` / ``grad`` / ``vmap`` / ``lax`` control flow.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import jax.numpy as jnp

Scalar = Union[jnp.ndarray, float, int]


class Vec3(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # ---- constructors ----
    @classmethod
    def full(cls, v: Scalar, like: "Vec3 | None" = None) -> "Vec3":
        v = jnp.asarray(v, dtype=jnp.float32)
        if like is not None:
            v = jnp.broadcast_to(v, jnp.shape(like.x))
        return cls(v, v, v)

    @classmethod
    def from_array(cls, a, axis: int = -1) -> "Vec3":
        a = jnp.asarray(a)
        parts = [jnp.take(a, i, axis=axis) for i in range(3)]
        return cls(*parts)

    def to_array(self, axis: int = -1) -> jnp.ndarray:
        return jnp.stack([self.x, self.y, self.z], axis=axis)

    # ---- arithmetic ----
    def _coerce(self, o):
        if isinstance(o, Vec3):
            return o
        return Vec3(o, o, o)

    def __add__(self, o) -> "Vec3":
        o = self._coerce(o)
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    __radd__ = __add__

    def __sub__(self, o) -> "Vec3":
        o = self._coerce(o)
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __rsub__(self, o) -> "Vec3":
        o = self._coerce(o)
        return Vec3(o.x - self.x, o.y - self.y, o.z - self.z)

    def __mul__(self, o) -> "Vec3":
        o = self._coerce(o)
        return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)

    __rmul__ = __mul__

    def __truediv__(self, o) -> "Vec3":
        o = self._coerce(o)
        return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)

    def __rtruediv__(self, o) -> "Vec3":
        o = self._coerce(o)
        return Vec3(o.x / self.x, o.y / self.y, o.z / self.z)

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    # ---- geometry ----
    def dot(self, o: "Vec3") -> jnp.ndarray:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length_sq(self) -> jnp.ndarray:
        return self.dot(self)

    def length(self) -> jnp.ndarray:
        return jnp.sqrt(self.length_sq())

    def normalize(self, eps: float = 0.0) -> "Vec3":
        inv = jnp.where(self.length_sq() > eps, 1.0 / self.length(), 0.0) \
            if eps > 0.0 else 1.0 / self.length()
        return self * inv

    def minimum(self, o: "Vec3") -> "Vec3":
        return Vec3(jnp.minimum(self.x, o.x), jnp.minimum(self.y, o.y),
                    jnp.minimum(self.z, o.z))

    def maximum(self, o: "Vec3") -> "Vec3":
        return Vec3(jnp.maximum(self.x, o.x), jnp.maximum(self.y, o.y),
                    jnp.maximum(self.z, o.z))

    def min_component(self) -> jnp.ndarray:
        return jnp.minimum(self.x, jnp.minimum(self.y, self.z))

    def max_component(self) -> jnp.ndarray:
        return jnp.maximum(self.x, jnp.maximum(self.y, self.z))

    def sum(self) -> jnp.ndarray:
        return self.x + self.y + self.z

    def luminance(self) -> jnp.ndarray:
        """Rec.709 luma — reference brdfs.glsl:108."""
        return 0.2126 * self.x + 0.7152 * self.y + 0.0722 * self.z

    def astype(self, dtype) -> "Vec3":
        return Vec3(self.x.astype(dtype), self.y.astype(dtype),
                    self.z.astype(dtype))


def where(mask, a: Vec3, b: Vec3) -> Vec3:
    """Componentwise select; `mask` broadcasts against each component."""
    return Vec3(jnp.where(mask, a.x, b.x), jnp.where(mask, a.y, b.y),
                jnp.where(mask, a.z, b.z))


def lerp(a: Vec3, b: Vec3, t) -> Vec3:
    return a + (b - a) * t


def reflect(d: Vec3, n: Vec3) -> Vec3:
    """GLSL reflect(): d - 2*dot(d, n)*n."""
    return d - n * (2.0 * d.dot(n))
