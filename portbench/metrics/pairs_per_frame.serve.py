"""pairs_per_frame.serve: the mean of the program's own counter
`RenderOutput.num_pairs` over the traced window's frames: the (tile,
gaussian) pairs binned, the work the gather, K1, K2 and K3 scale with.
Moves frames_per_s.
"""


def read(run):
    if run.kind != "serve" or not run.num_pairs:
        return None
    return sum(run.num_pairs) / len(run.num_pairs)
