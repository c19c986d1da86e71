from .bmp import quantize_image, read_bmp, write_bmp
from .obj import ObjMesh, load_obj

__all__ = ["ObjMesh", "load_obj", "quantize_image", "read_bmp", "write_bmp"]
