"""send_fill.train: the share of the exchange's send buffer that holds
payload rather than padding: 100 x the (gaussian, strip) rows packed
(counter `sent_rows` of `gs.exchange`, before any cap) over the rows the
fixed-size buffer moves (`send_slots`, strips x send_cap), summed over the
traced window's steps and the ranks; none where the program counts no
`send_slots`. Moves train_steps_per_s: the all_to_all moves the whole
buffer, padding included.
"""

from portbench.metrics import _spans


def read(run):
    got = [_spans.window_calls(r, "train") for r in run.ranks]
    if None in got:
        return None
    slots = sum(c.counter("send_slots") for calls in got for c in calls)
    if slots <= 0:
        return None
    return 100.0 * sum(c.counter("sent_rows") for calls in got
                       for c in calls) / slots
