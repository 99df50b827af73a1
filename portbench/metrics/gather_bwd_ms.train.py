"""gather_bwd_ms.train: the self device ms a step of the program's span
`gs.gather.bwd`, the gather's backward (`ops/binning.py`
`_GatherSorted.backward`: `reduce_pair_grads`, K3), averaged over the
traced window's steps; none off CUDA. Moves train_steps_per_s.
"""

from portbench.metrics import _spans


def read(run):
    return _spans.self_ms(run, "train", "gs.gather.bwd")
