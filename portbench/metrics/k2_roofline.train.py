"""k2_roofline.train: K2's (csrc/backward.cu) share of its roofline on the
steps the reference followed: the bound of their backward raster work
(reference/counts.py `kernel_bound('k2')`) over K2's device time on the
same launches (`backward_kernel`), summed over the ranks on several
cards. Moves train_steps_per_s.
"""

from portbench.reference import counts


def read(run):
    if run.kind != "train" or not all(r.k2_s for r in run.ranks):
        return None
    bound = sum(counts.kernel_bound("k2", c, run.pixels) for c in run.counts)
    return 100.0 * bound / sum(sum(r.k2_s) for r in run.ranks)
