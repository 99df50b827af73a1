"""Shared runner (no tests here) of the port's multi-process tests: a test
file is also its ranks' entry point,

    python tests/<file>.py --worker JOB --rank R --world N \
        --init file:///path/store --inputs in.npz --out DIR

and calls `worker_main` with its table of jobs and its case function. The
test process writes every input as numpy to `in.npz`; each rank runs the
cases of its job in one gloo process group (rendezvous through a
FileStore, no ports), writes its results to DIR/JOB_rank<R>.npz, and
imports neither JAX nor the reference package (it checks). Ranks run one
thread each and wait at most TIMEOUT_S on any collective; the test waits
4x that on a process, then kills it.
"""

import argparse
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 90


def worker_main(argv, jobs, run_case) -> int:
    """Run the cases `jobs[world]` in this rank: `run_case(case, inputs)`
    returns a dict of numpy arrays, saved under "case/key"."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=args.init, rank=args.rank,
                            world_size=args.world,
                            timeout=timedelta(seconds=TIMEOUT_S))
    try:
        inp = dict(np.load(args.inputs))
        res = {}
        for case in jobs[args.world]:
            for k, v in run_case(case, inp).items():
                res[f"{case}/{k}"] = v
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "gaussiansplat_tpu")]
        if bad:
            raise AssertionError(f"a rank imported {bad[:5]}")
        np.savez(os.path.join(args.out, f"{args.worker}_rank{args.rank}.npz"),
                 **res)
    finally:
        dist.destroy_process_group()
    return 0


def launch(script, world, tmp, inputs):
    """Start job `world` of `script` in `world` processes."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    store = tmp / f"store{world}"
    return [subprocess.Popen(
        [sys.executable, str(Path(script).resolve()), "--worker",
         f"w{world}", "--rank", str(r), "--world", str(world), "--init",
         f"file://{store}", "--inputs", str(inputs), "--out", str(tmp)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]


def wait(procs):
    """Wait for every process; fail on a non-zero exit, with its log."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=4 * TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"


def run_jobs(script, jobs, tmp, arrays):
    """Write `arrays` as the inputs, run every job (all started together)
    and return, for each case, the list of its ranks' result dicts."""
    inputs = tmp / "in.npz"
    np.savez(inputs, **arrays)
    procs = {w: launch(script, w, tmp, inputs) for w in jobs}
    try:
        for w in jobs:
            wait(procs[w])
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    results = {}
    for w, names in jobs.items():
        ranks = [dict(np.load(tmp / f"w{w}_rank{r}.npz")) for r in range(w)]
        for case in names:
            results[case] = [{k[len(case) + 1:]: v for k, v in rk.items()
                              if k.startswith(case + "/")} for rk in ranks]
    return results


def close_scaled(got, want, atol, what):
    """Every entry of got[k] within atol of want[k], both divided by the
    largest |want[k]| entry."""
    for k in want:
        w = np.asarray(want[k])
        scale = np.abs(w).max() + 1e-8
        np.testing.assert_allclose(np.asarray(got[k]) / scale, w / scale,
                                   atol=atol, err_msg=f"{what}: {k}")
