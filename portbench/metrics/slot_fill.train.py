"""slot_fill.train: the share of the pair slots the binning's pair sort and
the gather run over that hold a pair: 100 x the program's counters
`pairs` / `pair_slots` of the span `gs.bin`, summed over the traced
window's steps. Moves train_steps_per_s.
"""

from portbench.metrics import _spans


def read(run):
    return _spans.slot_fill(run, "train")
