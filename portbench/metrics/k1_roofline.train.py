"""k1_roofline.train: K1's share of its roofline on the steps the
reference followed: the bound of their forward work (reference/counts.py
`kernel_bound('k1')`) over K1's device time on the same launches
(`forward_kernel`, traced through those steps), summed over the ranks on
several cards. Moves train_steps_per_s.
"""

from portbench.reference import counts


def read(run):
    if run.kind != "train" or not all(r.k1_s for r in run.ranks):
        return None
    bound = sum(counts.kernel_bound("k1", c, run.pixels) for c in run.counts)
    return 100.0 * bound / sum(sum(r.k1_s) for r in run.ranks)
