"""mfu.serve: the frame's share of the card's float32 peak.

The operations a frame of these inputs needs (reference/counts.py
`serve_flops`, on the reference's counts of the compared frames, averaged),
times the frames the traced window completed, over the window's host-clock
seconds and the 67 TFLOP/s peak of each card the cell runs on. Moves
frames_per_s.
"""

from portbench.reference import counts, peaks


def read(run):
    if run.kind != "serve" or not run.counts:
        return None
    flops = sum(counts.serve_flops(run.alive, run.sh_degree, run.pixels, c)
                for c in run.counts) / len(run.counts)
    chips = len(run.ranks)
    return (100.0 * flops * run.calls / run.window_s
            / (peaks.PEAK_FP32_FLOPS * chips))
