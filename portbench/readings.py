#!/usr/bin/env python3
"""The readings that the limits of a cell are set from, in one process.

    python3 portbench/readings.py --workload <name> --seeds 11 12 ... \
        --seconds 2 [--controls 3]

For each seed, a run of the cell as run.py makes it (with a short window)
and the numbers it compares; then, on the first --controls seeds, the
control's and the faults' numbers (portbench/control.py). One JSON line
each; the last line holds the largest program reading and the smallest
control or fault reading of every number. Kernels build once, so a dozen
seeds cost one set-up of the process. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
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

    from portbench import cells, control, drive, harness

    cell = cells.load(args.workload, root)
    if device == "cuda":
        import torch

        torch.set_num_threads(1)
        drive.load_kernels()
    program, controls = [], []
    for seed in args.seeds:
        t = time.perf_counter()
        out = harness.run(cell, seed, args.seconds, False, device,
                          time.perf_counter(), {})
        program.append(out.numbers)
        print(json.dumps(dict(seed=seed, program=out.numbers,
                              correct=out.correct,
                              end_to_end=out.end_to_end, detail=out.detail,
                              seconds=time.perf_counter() - t)), flush=True)
        harness._free(device)
    for seed in args.seeds[:args.controls]:
        t = time.perf_counter()
        r = control.readings(cell, seed, device)
        controls.append(r)
        print(json.dumps(dict(seed=seed, **r,
                              seconds=time.perf_counter() - t)), flush=True)
        harness._free(device)
    lower = {k: max(p[k] for p in program) for k in program[0]}
    print(json.dumps(dict(workload=cell.name, seeds=len(program),
                          lower=lower, upper=control.worst(controls))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
