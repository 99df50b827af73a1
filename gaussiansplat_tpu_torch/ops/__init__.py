from .binning import TileBinning, bin_gaussians, tile_grid
from .camera import Camera, camera_from_numpy, look_at, make_camera, orbit_camera
from .projection import Projected, make_payload, project_gaussians
from .oracle import render_oracle, render_oracle_full
