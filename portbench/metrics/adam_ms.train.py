"""adam_ms.train: device milliseconds a step of the kernels launched
inside torch's `Optimizer.step#Adam.step` range, from the trace, averaged
over the traced window's steps; on several cards, the slowest rank's.
Moves train_steps_per_s.
"""


def read(run):
    per_rank = []
    for r in run.ranks:
        if r.kind != "train" or not r.trace.adam_s:
            return None
        if max(r.trace.adam_s) <= 0:
            return None
        per_rank.append(1e3 * sum(r.trace.adam_s) / len(r.trace.adam_s))
    return max(per_rank)
