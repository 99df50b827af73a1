"""raster_ms.serve: the self device ms a frame of the program's span
`gs.raster`, the raster (`ops/raster_dispatch.py`: `rasterize_tiles`, K1
and the compositing), averaged over the traced window's frames; none off
CUDA. Moves frames_per_s.
"""

from portbench.metrics import _spans


def read(run):
    return _spans.self_ms(run, "serve", "gs.raster")
