from .image import read_png, read_png_luma, write_png, resize_nearest, to_luma
from .jpeg import read_jpeg, write_jpeg
from .pfm import read_pfm, write_pfm
from .ply import read_ply, write_ply

__all__ = ["read_png", "read_png_luma", "write_png", "read_jpeg", "write_jpeg",
           "resize_nearest", "to_luma", "read_pfm", "write_pfm", "read_ply", "write_ply"]
