from gdpathtracing.scene.scene import Scene, SceneBuilder
from gdpathtracing.scene.materials import Material
from gdpathtracing.scene.objloader import load_obj

__all__ = ["Scene", "SceneBuilder", "Material", "load_obj"]
