"""step_self_ms.train: the self device ms a step of the program's span
`gs.step`, the step outside its layers (`train/trainer.py` `step_fn`:
zero_grad, the offset, the densify statistics, the metrics), averaged
over the traced window's steps; none off CUDA. Moves train_steps_per_s.
"""

from portbench.metrics import _spans


def read(run):
    return _spans.self_ms(run, "train", "gs.step")
