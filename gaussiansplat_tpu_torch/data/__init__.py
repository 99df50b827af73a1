from .cameras import load_cameras_json
from .ply import load_gaussian_ply, read_ply, save_gaussian_ply, write_ply
