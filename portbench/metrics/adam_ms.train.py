"""adam_ms.train: device milliseconds a step of the kernels launched
inside torch's `Optimizer.step#Adam.step` range, from the trace, averaged
over the traced window's steps. Moves train_steps_per_s.
"""


def read(run):
    if run.kind != "train" or not run.trace.adam_s:
        return None
    if max(run.trace.adam_s) <= 0:
        return None
    return 1e3 * sum(run.trace.adam_s) / len(run.trace.adam_s)
