"""A program path found by name, and cells on several ranks, on the CPU
(tests/tiny.py's copy; gloo ranks):

- the copy gains, as new files only, a program file that wraps the port's
  gaussian-axis sharded render and step (sharded_program.py), a
  configuration that names it, traffic mixes and limits; a `chips: 2`
  serve cell and a `chips: 2` train cell run end to end through
  `run.main(device="cpu")`, correct, on two devices;
- a program that raises on rank 1 ends the job with a non-zero exit, that
  rank's traceback last on standard error and no rank left alive;
- a configuration that names a program with no file fails at once;
- readings.py runs the `chips: 2` train cell's seeds as one job of ranks
  and its control and fault in its own process.
Each case runs in a process of its own, under a limit of LIMIT_S.
"""

import hashlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from tiny import make_root  # noqa: E402

SEED = 4294967311
LIMIT_S = 120
FAILING = '''

import os

_serve_setup = serve_setup


def serve_setup(cell, inputs, device):
    if os.environ["RANK"] == "1":
        raise RuntimeError("rank 1 fails in its set-up")
    return _serve_setup(cell, inputs, device)
'''
# name: (config, traffic, limits copied from, the cell whose metrics it reports)
CELLS = {
    "tiny_sharded_serve": ("tiny_sharded", "tiny_orbit_square", "tiny_serve"),
    "tiny_sharded_train": ("tiny_sharded", "tiny_views_square", "tiny_train"),
    "tiny_failing_serve": ("tiny_failing", "tiny_orbit_square", "tiny_serve"),
    "tiny_missing_serve": ("tiny_missing", "tiny_orbit_square", "tiny_serve"),
}
PROGRAMS = {"tiny_sharded": "gauss_sharded", "tiny_failing": "gauss_failing",
            "tiny_missing": "no_such_program"}


def _hashes(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def _json(path, obj):
    path.write_text(json.dumps(obj, indent=1))


def make_ranks_root(dest: Path, chips: int = 2) -> Path:
    """tiny.py's copy under `dest`, with the cells above on `chips` ranks
    added by new files and BENCHMARK.json entries alone."""
    root = make_root(dest)
    before = _hashes(root)
    pb = root / "portbench"
    sharded = (HERE / "sharded_program.py").read_text()
    (pb / "programs" / "gauss_sharded.py").write_text(sharded)
    (pb / "programs" / "gauss_failing.py").write_text(sharded + FAILING)
    cfg = json.loads((pb / "configs" / "tiny_scene.json").read_text())
    for name, program in PROGRAMS.items():
        _json(pb / "configs" / f"{name}.json", dict(cfg, program=program))
    # Two tile rows a rank: the strips of one row that four ranks would
    # get are crossed by so many gaussians that the exchange drops some.
    for src, dst in (("tiny_orbit", "tiny_orbit_square"),
                     ("tiny_views", "tiny_views_square")):
        tr = json.loads((pb / "traffic" / f"{src}.json").read_text())
        _json(pb / "traffic" / f"{dst}.json", dict(tr, height=32 * chips))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"] += [dict(name=n, source="tiny",
                             file=f"portbench/configs/{n}.json", reduced=[],
                             why="tiny") for n in PROGRAMS]
    for name, (config, traffic, like) in CELLS.items():
        shutil.copy(pb / "limits" / f"{like}.json", pb / "limits" / f"{name}.json")
        spec["workloads"].append(dict(name=name, config=config,
                                      traffic=traffic, chips=chips,
                                      why="tiny"))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    _json(root / "BENCHMARK.json", spec)
    after = _hashes(root)
    assert {p for p in before if before[p] != after.get(p)} == {
        root / "BENCHMARK.json"}
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_ranks_root(tmp_path_factory.mktemp("checkout"))


def _main(root, module, argv):
    """portbench.<module>.main(argv) in a process of its own; (exit code,
    stdout, stderr)."""
    script = (f"import sys; from pathlib import Path; "
              f"sys.path[:0] = [{str(REPO)!r}]; "
              f"from portbench import {module}; "
              f"sys.exit({module}.main({argv!r}, root=Path({str(root)!r}), "
              f"device='cpu'))")
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=LIMIT_S, cwd=REPO)
    return p.returncode, p.stdout, p.stderr


def _run(root, workload, trace=0):
    return _main(root, "run", ["--workload", workload, "--seed", str(SEED),
                               "--seconds", "0.3", "--trace", str(trace)])


def _left_alive(root):
    """Processes whose command line names the copy: ranks left behind."""
    mark = str(root).encode()
    found = []
    for p in Path("/proc").iterdir():
        if p.name.isdigit():
            try:
                if mark in (p / "cmdline").read_bytes():
                    found.append(int(p.name))
            except OSError:
                pass
    return found


@pytest.mark.parametrize("workload,trace", [("tiny_sharded_serve", 1),
                                            ("tiny_sharded_train", 0)])
def test_a_cell_on_two_ranks(root, workload, trace):
    rc, out, err = _run(root, workload, trace)
    assert rc == 0, err[-4000:]
    lines = out.strip().splitlines()
    assert lines[-2].startswith("setup_parts ")
    res = json.loads(lines[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["count"] == 2
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert "mfu.serve" in res["metrics"]
    else:
        assert set(res["metrics"]) == {"train_steps_per_s", "setup_s"}
    assert _left_alive(root) == []


def test_a_failing_rank_ends_the_job(root):
    rc, out, err = _run(root, "tiny_failing_serve")
    assert rc != 0
    assert not out.strip()
    assert err.strip().splitlines()[-1] == (
        "RuntimeError: rank 1 fails in its set-up")
    assert _left_alive(root) == []


def test_a_missing_program_fails_at_once(root):
    t = time.perf_counter()
    rc, out, err = _run(root, "tiny_missing_serve")
    assert rc != 0 and not out.strip()
    assert err.strip().splitlines() == [
        "portbench: configuration 'tiny_missing' names the program "
        "'no_such_program', and portbench/programs/no_such_program.py is not "
        "there"]
    assert time.perf_counter() - t < 60


def test_readings_of_a_cell_on_two_ranks(root):
    rc, out, err = _main(root, "readings", [
        "--workload", "tiny_sharded_train", "--seeds", str(SEED),
        str(SEED + 1), "--seconds", "0.3", "--controls", "1"])
    assert rc == 0, err[-4000:]
    lines = [json.loads(x) for x in out.strip().splitlines()]
    assert [x["seed"] for x in lines[:3]] == [SEED, SEED + 1, SEED]
    assert all(x["correct"] for x in lines[:2]), lines[:2]
    assert set(lines[2]) == {"seed", "control", "half_batch", "seconds"}
    limits = json.loads(
        (root / "portbench" / "limits" / "tiny_sharded_train.json").read_text())
    last = lines[3]
    assert last["seeds"] == 2 and set(last["lower"]) == set(limits)
    assert set(last["upper"]) == {"control", "half_batch"}
    assert _left_alive(root) == []
