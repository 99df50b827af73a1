"""binning_ms.train: the self device ms a step of the program's span
`gs.bin`, the binning (`ops/binning.py` via `render.py`: the compaction
sort, K4, the pair sort, the segments), averaged over the traced
window's steps; none off CUDA. Moves train_steps_per_s.
"""

from portbench.metrics import _spans


def read(run):
    return _spans.self_ms(run, "train", "gs.bin")
