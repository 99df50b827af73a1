"""project_ms.serve: the self device ms a frame of the program's span
`gs.project`, the projection and the raster payload (`render.py`:
`project_gaussians`, `make_payload`), averaged over the traced window's
frames; none off CUDA. Moves frames_per_s.
"""

from portbench.metrics import _spans


def read(run):
    return _spans.self_ms(run, "serve", "gs.project")
