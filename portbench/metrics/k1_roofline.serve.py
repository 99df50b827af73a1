"""k1_roofline.serve: K1's (csrc/forward.cu) share of its roofline on the
compared frames: the bound of the work these frames need (reference/
counts.py `kernel_bound('k1')`, on the reference's counts) over K1's device
time on the same launches (`forward_kernel` in the trace), summed over
the ranks on several cards. Moves frames_per_s.
"""

from portbench.reference import counts


def read(run):
    if run.kind != "serve" or not all(r.k1_s for r in run.ranks):
        return None
    bound = sum(counts.kernel_bound("k1", c, run.pixels) for c in run.counts)
    return 100.0 * bound / sum(sum(r.k1_s) for r in run.ranks)
