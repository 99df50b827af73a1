"""idle_share.train: the share of the traced window in which the card ran
nothing: 1 - (union of kernel, copy and memset intervals) / window, from
torch.profiler's device trace; on several cards, the mean over the
ranks. Moves train_steps_per_s.
"""


def read(run):
    if run.kind != "train" or any(r.trace.busy_s <= 0 for r in run.ranks):
        return None
    return sum(100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
               for r in run.ranks) / len(run.ranks)
