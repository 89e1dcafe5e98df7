from .image import read_png, write_png, resize_nearest
from .pfm import read_pfm, write_pfm
from .ply import read_ply, write_ply

__all__ = ["read_png", "write_png", "resize_nearest", "read_pfm", "write_pfm",
           "read_ply", "write_ply"]
