"""What the per-layer span metrics share: the program's own spans and
counters (gaussiansplat_tpu_torch/utils/logging.py), recorded while the
traced window ran under torch.profiler and kept in each rank's RunData
(`spans`, harness.window_spans).

A serve window's frames are its `gs.render` calls, a train window's steps
its `gs.step` calls: the last `run.calls` of them, which leaves out the
training cell's three traced warm-up steps. Every reader returns None
where the program records no spans (a tree without them), where fewer
calls were recorded than the window completed, and, for device times,
off CUDA. On several cards a time is the slowest rank's and a counter the
sum over the ranks.
"""

TOP = {"serve": "gs.render", "train": "gs.step"}


def window_calls(run, kind):
    """The window's calls of one rank's RunData, oldest first, or None."""
    if run.kind != kind or run.calls < 1 or run.spans is None:
        return None
    got = [c for c in run.spans if c.top == TOP[kind]]
    if len(got) < run.calls:
        return None
    return got[len(got) - run.calls:]


def self_ms(run, kind, name):
    """Mean self device ms a call of the spans named `name`, on the
    slowest rank."""
    per_rank = []
    for r in run.ranks:
        got = window_calls(r, kind)
        if got is None:
            return None
        ms = [c.self_ms(name) for c in got]
        if None in ms:
            return None
        per_rank.append(sum(ms) / len(ms))
    return max(per_rank)


def slot_fill(run, kind):
    """100 x the pairs binned over the pair slots processed (counters
    `pairs` and `pair_slots` of `gs.bin`), summed over the window and the
    ranks."""
    got = [window_calls(r, kind) for r in run.ranks]
    if None in got:
        return None
    slots = sum(c.counter("pair_slots") for calls in got for c in calls)
    if slots <= 0:
        return None
    return 100.0 * sum(c.counter("pairs") for calls in got for c in calls) / slots
