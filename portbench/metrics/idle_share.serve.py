"""idle_share.serve: the share of the traced window in which the card ran
nothing: 1 - (union of kernel, copy and memset intervals) / window, from
torch.profiler's device trace. Moves frames_per_s.
"""


def read(run):
    if run.kind != "serve" or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
