"""optimizer_ms.train: the self device ms a step of the program's span
`gs.optimizer`, the optimizer (`train/trainer.py`: `set_position_lr`,
`optimizer.step()`), averaged over the traced window's steps; none off
CUDA. Moves train_steps_per_s.
"""

from portbench.metrics import _spans


def read(run):
    return _spans.self_ms(run, "train", "gs.optimizer")
