from .ply import read_ply, write_ply

__all__ = ["read_ply", "write_ply"]
