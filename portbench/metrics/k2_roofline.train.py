"""k2_roofline.train: K2's (csrc/backward.cu) share of its roofline on the
steps the reference followed: the bound of their backward raster work
(reference/counts.py `kernel_bound('k2')`) over K2's device time on the
same launches (`backward_kernel`). Moves train_steps_per_s.
"""

from portbench.reference import counts


def read(run):
    if run.kind != "train" or not run.k2_s:
        return None
    bound = sum(counts.kernel_bound("k2", c, run.pixels) for c in run.counts)
    return 100.0 * bound / sum(run.k2_s)
