#!/usr/bin/env python3
"""The readings that the limits of a cell are set from, in one process.

    python3 portbench/readings.py --workload <name> --seeds 11 12 ... \
        --seconds 2 [--controls 3]

For each seed, a run of the cell as run.py makes it (with a short window)
and the numbers it compares; then, on the first --controls seeds, the
control's and the faults' numbers (portbench/control.py). One JSON line
each; the last line holds the largest program reading and the smallest
control or fault reading of every number. Kernels build once, so a dozen
seeds cost one set-up of the process. A cell on several cards runs its
seeds as one job of ranks (ranks.launch), and the control and the faults,
which run the reference alone, in this process. Not part of a benchmark
run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None, root: Path = ROOT, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--controls", type=int, default=0)
    args = ap.parse_args(argv)

    from portbench import cells, control, harness, ranks

    cell = cells.load(args.workload, root)
    if cell.chips == 1:
        found = seeds(args, cell, device, lambda k: ranks.SOLO)
    else:
        try:
            found = ranks.launch(cell.chips, seeds_rank,
                                 (args, root, device, os.getpid()))
        except ranks.JobFailed as e:
            print(e.args[0], file=sys.stderr, flush=True)
            return 5
    # The control and the faults run the reference alone, in this process.
    device = "cuda:0" if device == "cuda" else device
    controls = []
    for seed in args.seeds[:args.controls]:
        t = time.perf_counter()
        r = control.readings(cell, seed, device)
        controls.append(r)
        print(json.dumps(dict(seed=seed, **r,
                              seconds=time.perf_counter() - t)), flush=True)
        harness._free(device)
    lower = {k: max(p[k] for p in found) for k in found[0]}
    print(json.dumps(dict(workload=cell.name, seeds=len(found),
                          lower=lower, upper=control.worst(controls))),
          flush=True)
    return 0


def seeds(args, cell, device: str, peers_of) -> list:
    """This rank's run of the cell on each seed, with `peers_of(k)` as its
    peers on the k-th; rank 0 prints a line for each and returns the numbers of
    all (each at its worst rank)."""
    import torch

    from portbench import cells, harness

    program = cells.program(cell)
    if device != "cpu" or cell.chips > 1:
        # As run.py: one intra-op thread; the ranks share the host's cores.
        torch.set_num_threads(1)
    if device != "cpu":
        program.load_kernels()
    found = []
    for k, seed in enumerate(args.seeds):
        t = time.perf_counter()
        peers = peers_of(k)
        out = harness.run(cell, program, seed, args.seconds, False, device,
                          time.perf_counter(), {}, peers)
        outs = peers.gather(out)
        harness._free(device)
        if peers.rank:
            continue
        out = harness.merge(outs)
        found.append(out.numbers)
        print(json.dumps(dict(seed=seed, program=out.numbers,
                              correct=out.correct,
                              end_to_end=out.end_to_end, detail=out.detail,
                              seconds=time.perf_counter() - t)), flush=True)
    return found


def seeds_rank(args, root: Path, device: str, launcher: int) -> list:
    """`seeds` on one rank of a cell on several cards (ranks.launch)."""
    from portbench import cells, ranks

    device = ranks.start_rank(launcher, device)
    cell = cells.load(args.workload, root)
    try:
        return seeds(args, cell, device,
                     lambda k: ranks.Group(args.seconds, tag=f"/{k}"))
    finally:
        ranks.close_group()


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
