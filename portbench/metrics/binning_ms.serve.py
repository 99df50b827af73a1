"""binning_ms.serve: the self device ms a frame of the program's span
`gs.bin`, the binning (`ops/binning.py` via `render.py`: the compaction
sort, K4, the pair sort, the segments), averaged over the traced
window's frames; none off CUDA. Moves frames_per_s.
"""

from portbench.metrics import _spans


def read(run):
    return _spans.self_ms(run, "serve", "gs.bin")
