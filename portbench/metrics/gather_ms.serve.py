"""gather_ms.serve: the self device ms a frame of the program's span
`gs.gather`, the payload gather into sorted pair order
(`ops/raster_dispatch.py`: `gather_payload`), averaged over the traced
window's frames; none off CUDA. Moves frames_per_s.
"""

from portbench.metrics import _spans


def read(run):
    return _spans.self_ms(run, "serve", "gs.gather")
