"""pairs_per_frame.serve: the mean of the program's own counter
`RenderOutput.num_pairs` over the traced window's frames: the (tile,
gaussian) pairs binned, the work the gather, K1, K2 and K3 scale with;
summed over the ranks on several cards. Moves frames_per_s.
"""


def read(run):
    if run.kind != "serve" or not all(r.num_pairs for r in run.ranks):
        return None
    return sum(sum(r.num_pairs) for r in run.ranks) / len(run.num_pairs)
