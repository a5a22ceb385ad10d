from gdpathtracing.render.camera import Camera
from gdpathtracing.render.types import Ray, HitInfo, ShadingInfo

__all__ = ["Camera", "Ray", "HitInfo", "ShadingInfo"]
