"""loss_ms.train: the self device ms a step of the program's span
`gs.loss`, the L1 + DSSIM loss (`train/trainer.py`: `photometric_loss`),
averaged over the traced window's steps; none off CUDA. Moves
train_steps_per_s.
"""

from portbench.metrics import _spans


def read(run):
    return _spans.self_ms(run, "train", "gs.loss")
