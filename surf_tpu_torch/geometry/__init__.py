from .mesh import Mesh
from .marching_cubes import marching_cubes
from .extract import extract_geometry
from .clean_mesh import clean_mesh, clean_mesh_by_mask, clean_mesh_outside_frustum, dilate_masks

__all__ = ["Mesh", "marching_cubes", "extract_geometry", "clean_mesh",
           "clean_mesh_by_mask", "clean_mesh_outside_frustum", "dilate_masks"]
