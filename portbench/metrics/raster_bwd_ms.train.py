"""raster_bwd_ms.train: the self device ms a step of the program's span
`gs.raster.bwd`, the raster's backward (`ops/kernels/rasterize.py`
`_Rasterize.backward`: the cotangents, K2), averaged over the traced
window's steps; none off CUDA. Moves train_steps_per_s.
"""

from portbench.metrics import _spans


def read(run):
    return _spans.self_ms(run, "train", "gs.raster.bwd")
