from .bmp import quantize_image, read_bmp, write_bmp
from .obj import ObjMesh, load_obj
from .ply import PlyParseError, load_ply, save_ply

__all__ = ["ObjMesh", "PlyParseError", "load_obj", "load_ply", "quantize_image", "read_bmp",
           "save_ply", "write_bmp"]
