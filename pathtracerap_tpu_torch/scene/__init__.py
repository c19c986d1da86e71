from .build import SceneBuilder, build_cornell_box_scene, build_reference_scene
from .types import Material, MaterialType, SceneDevice, SceneHost, WorldTriangles

__all__ = [
    "SceneBuilder",
    "build_cornell_box_scene",
    "build_reference_scene",
    "Material",
    "MaterialType",
    "SceneDevice",
    "SceneHost",
    "WorldTriangles",
]
