from .benchmark import benchmark_scene, hemisphere_cameras, make_gt_model
from .cameras import load_cameras_json, save_cameras_json
from .datasets import Scene, colmap_scene, nerf_synthetic_scene, synthetic_scene
from .ply import load_gaussian_ply, read_ply, save_gaussian_ply, write_ply

__all__ = [
    "Scene",
    "benchmark_scene",
    "colmap_scene",
    "hemisphere_cameras",
    "load_cameras_json",
    "load_gaussian_ply",
    "make_gt_model",
    "nerf_synthetic_scene",
    "read_ply",
    "save_cameras_json",
    "save_gaussian_ply",
    "synthetic_scene",
    "write_ply",
]
