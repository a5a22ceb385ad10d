from gdpathtracing.core.vec import Vec3
from gdpathtracing.core import rng, math3d

__all__ = ["Vec3", "rng", "math3d"]
