"""strip_skew.train: the load imbalance of the strips (Grendel's): each
rank's mean self device ms a step of the spans that work on its strip
alone, `gs.bin`, `gs.gather`, `gs.raster`, `gs.raster.bwd` and
`gs.gather.bwd`, the slowest rank's over the mean of the ranks, over the
traced window's steps; 1 is even. None off CUDA or where a rank records
no `gs.bin` span. Moves train_steps_per_s: every step waits for the
slowest strip at the exchange's reverse and the strips' gather.
"""

from portbench.metrics import _spans

SPANS = ("gs.bin", "gs.gather", "gs.raster", "gs.raster.bwd",
         "gs.gather.bwd")


def read(run):
    per_rank = []
    for r in run.ranks:
        calls = _spans.window_calls(r, "train")
        if calls is None or any(c.ms is None or "gs.bin" not in c.ms
                                for c in calls):
            return None
        per_rank.append(sum(c.self_ms(n) for c in calls for n in SPANS)
                        / len(calls))
    mean = sum(per_rank) / len(per_rank)
    return max(per_rank) / mean if mean > 0 else None
