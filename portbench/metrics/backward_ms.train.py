"""backward_ms.train: the self device ms a step of the program's span
`gs.backward`, `loss.backward()` outside K2's and K3's spans: the
autograd of the projection and of the loss, averaged over the traced
window's steps; none off CUDA. Moves train_steps_per_s.
"""

from portbench.metrics import _spans


def read(run):
    return _spans.self_ms(run, "train", "gs.backward")
