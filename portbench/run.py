#!/usr/bin/env python3
"""Run one cell of the benchmark of gaussiansplat_tpu_torch once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. Makes the cell's inputs from the seed, sets the program up and warms
every shape, measures for --seconds (traced by torch.profiler with
--trace 1), then checks what the window produced against the plain
reference in portbench/reference/. Prints, on standard output, a line
`setup_parts {...}` (the set-up's parts in seconds) and, last, one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics), `device`,
with --trace 1 `breakdown` and `traced`, then `card` and, last, `checks`
(each number compared, with its limit). The same numbers are the last
lines of standard error.

A cell whose `chips` is above 1 runs as one process a card
(portbench/ranks.py): this process starts them through torch's elastic
launcher, each with torchrun's environment, and prints rank 0's lines.

Exits 3 without a result when torch sees no CUDA card or fewer than the
cell asks for, 2 when the cell's files are not there, and non-zero when
the run loaded jax, jaxlib, flax or gaussiansplat_tpu or a rank failed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def process_start() -> float:
    """The perf_counter reading at which this process started."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not measured"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def require_chip(chips: int) -> bool:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: this cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return False
    return True


def result_line(cell, out, trace: bool, device: str, readers) -> dict:
    import torch

    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = readers[m["name"]](out.run)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
    else:
        metrics = {m["name"]: dict(value=out.end_to_end[m["name"]],
                                   unit=m["unit"]) for m in cell.end_to_end}
    cuda = torch.device(device).type == "cuda"
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(0) if cuda else "cpu",
               count=cell.chips, memory_peak_bytes=out.memory_peak_bytes)
    res = dict(correct=out.correct, attempted=out.attempted,
               failed=out.failed, metrics=metrics, device=dev)
    if trace:
        red = out.run.trace
        # Device-busy seconds averaged over the cards; rank 0's window.
        dev["busy_s"] = (sum(r.trace.busy_s for r in out.run.ranks)
                         / len(out.run.ranks))
        dev["window_s"] = red.window_s
        res["breakdown"] = dict(device_ops=[list(x) for x in red.device_ops],
                                idle_gaps=[list(x) for x in red.idle_gaps])
        res["traced"] = dict(calls_per_s=out.traced_rate)
    res["check_s"] = out.check_s
    res["card"] = card_line() if cuda else "cpu"
    res["checks"] = out.checks
    return res


def main(argv=None, root: Path = ROOT, device: str = "cuda") -> int:
    t_start = process_start()
    args = parse(argv)
    from portbench import cells, ranks

    try:
        cell = cells.load(args.workload, root)
    except (KeyError, ValueError, FileNotFoundError) as e:
        print(f"portbench: {e.args[0]}", file=sys.stderr)
        return 2
    if device == "cuda" and not require_chip(cell.chips):
        return 3
    if cell.chips == 1:
        rc, out, err = one_rank(args, cell, device, t_start, ranks.SOLO)
    else:
        try:
            rc, out, err = ranks.launch(
                cell.chips, rank_main,
                (args, root, device, t_start, os.getpid()))
        except ranks.JobFailed as e:
            print(e.args[0], file=sys.stderr, flush=True)
            return 5
    from portbench import harness

    bad = harness.forbidden_modules()
    if bad:
        rc, out, err = 4, [], [f"portbench: the run loaded {', '.join(bad)}"]
    for line in err:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    for line in out:
        print(line)
    sys.stdout.flush()
    return rc


def rank_main(args, root: Path, device: str, t_start: float, launcher: int):
    """One rank of a cell on several cards, as ranks.launch starts it."""
    from portbench import cells, ranks

    device = ranks.start_rank(launcher, device)
    os.dup2(2, 1)  # only the launcher writes standard output
    cell = cells.load(args.workload, root)
    return one_rank(args, cell, device, t_start, ranks.Group(args.seconds))


def one_rank(args, cell, device: str, t_start: float, peers):
    """This rank's run: (exit code, lines of standard output, lines of
    standard error); rank 0's make the result."""
    import torch

    from portbench import cells, harness, ranks

    program = cells.program(cell)
    parts = dict(import_s=time.perf_counter() - t_start)
    if peers.world > 1 or device != "cpu":
        # One intra-op thread: the host-bound cells' rate varies less when
        # no idle pool of threads contends with the launching thread, and
        # the ranks of a job share the host's cores.
        torch.set_num_threads(1)
    if torch.device(device).type == "cuda":
        t = time.perf_counter()
        torch.cuda.init()
        torch.zeros(1, device=device)
        parts["cuda_init_s"] = time.perf_counter() - t
        t = time.perf_counter()
        program.load_kernels()
        parts["kernels_s"] = time.perf_counter() - t
    readers = cells.readers(cell) if args.trace else {}
    out = harness.run(cell, program, args.seed, args.seconds,
                      bool(args.trace), device, t_start, parts, peers)
    if peers.rank:
        bad = harness.forbidden_modules()
        if bad:
            raise RuntimeError(f"portbench: rank {peers.rank} loaded "
                               f"{', '.join(bad)}")
        peers.gather(out)
        ranks.close_group()
        return 0, [], []
    outs = peers.gather(out)
    ranks.close_group()
    out = harness.merge(outs)
    res = result_line(cell, out, bool(args.trace), device, readers)
    # After the readers, which run in this process.
    bad = harness.forbidden_modules()
    if bad:
        return 4, [], [f"portbench: the run loaded {', '.join(bad)}"]
    err = [f"check {name} {c['value']!r} limit {c['limit']!r} "
           f"{'ok' if c['value'] <= c['limit'] else 'OVER'}"
           for name, c in out.checks.items()]
    return 0, ["setup_parts " + json.dumps(out.parts), json.dumps(res)], err


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
