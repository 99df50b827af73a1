"""gather_ms.train: the self device ms a step of the program's span
`gs.gather`, the payload gather into sorted pair order
(`ops/raster_dispatch.py`: `gather_payload`), averaged over the traced
window's steps; none off CUDA. Moves train_steps_per_s.
"""

from portbench.metrics import _spans


def read(run):
    return _spans.self_ms(run, "train", "gs.gather")
