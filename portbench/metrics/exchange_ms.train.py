"""exchange_ms.train: the self device ms a step of the program's spans
`gs.pack`, `gs.exchange` and `gs.exchange.bwd` together
(`parallel/gauss_shard.py`: the pack of the payload rows by destination
strip, the payload `all_to_all`, and its reverse in the backward),
averaged over the traced window's steps, on the slowest rank; none off
CUDA or where the program records no `gs.exchange` span. Moves
train_steps_per_s.
"""

from portbench.metrics import _spans

SPANS = ("gs.pack", "gs.exchange", "gs.exchange.bwd")


def read(run):
    per_rank = []
    for r in run.ranks:
        calls = _spans.window_calls(r, "train")
        if calls is None or any(c.ms is None or "gs.exchange" not in c.ms
                                for c in calls):
            return None
        per_rank.append(sum(c.self_ms(n) for c in calls for n in SPANS)
                        / len(calls))
    return max(per_rank)
