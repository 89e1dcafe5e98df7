from .mesh import Mesh
from .marching_cubes import marching_cubes
from .extract import extract_geometry

__all__ = ["Mesh", "marching_cubes", "extract_geometry"]
