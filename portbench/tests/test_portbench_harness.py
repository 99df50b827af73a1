"""The harness end to end on the CPU at a tiny size (tests/tiny.py):

- a copy that gains a configuration, a traffic mix, a per-layer metric and
  a cell's limits as new files only, which the harness finds by name;
- the control (the reference with a bfloat16 payload) and the half-batch
  fault, put in the program's place, read over the cells' limits;
- the timed path broken underneath a whole run (a frame altered where it is
  produced; a step that returns its state unchanged; a step whose loss
  leaves out half of the batch): `correct` comes out false, while the
  unbroken run comes out true;
- with a card (marked gpu), a tiny cell through the CUDA kernels.
The look for a chip is skipped by running on device='cpu'.
"""

import hashlib
import io
import json
import shutil
import sys
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from portbench import cells, control, run  # noqa: E402
from tiny import make_root  # noqa: E402

SEED = 4294967311


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("checkout"))


def _run(root, workload, trace=0, seconds=0.3, device="cpu"):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", workload, "--seed", str(SEED),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      root=root, device=device)
    assert rc == 0, err.getvalue()
    lines = out.getvalue().strip().splitlines()
    assert lines[-2].startswith("setup_parts ")
    res = json.loads(lines[-1])
    assert list(res)[-1] == "checks"
    assert err.getvalue().strip().splitlines()[-1].startswith("check ")
    return res


def _hashes(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def test_new_files_alone_add_a_cell_and_a_metric(root, tmp_path):
    shutil.copytree(root, tmp_path / "c")
    root = tmp_path / "c"
    before = _hashes(root)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "tiny_scene.json").read_text())
    cfg["scene"]["n"] = 800
    (pb / "configs" / "tiny_scene_b.json").write_text(json.dumps(cfg))
    tr = json.loads((pb / "traffic" / "tiny_orbit.json").read_text())
    tr["elevation_deg"] = [20.0, 30.0]
    (pb / "traffic" / "tiny_orbit_high.json").write_text(json.dumps(tr))
    (pb / "metrics" / "frames_traced.serve.py").write_text(
        "def read(run):\n    return run.calls if run.kind == 'serve' else None\n")
    (pb / "limits" / "tiny_serve_b.json").write_text(
        (pb / "limits" / "tiny_serve.json").read_text())
    # BENCHMARK.json gains entries; no file of the harness is touched.
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="tiny_scene_b", source="tiny",
                                file="portbench/configs/tiny_scene_b.json",
                                reduced=[], why="tiny"))
    spec["workloads"].append(dict(name="tiny_serve_b", config="tiny_scene_b",
                                  traffic="tiny_orbit_high", chips=1,
                                  why="tiny"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "tiny_serve" in m.get("workloads", []):
            m["workloads"].append("tiny_serve_b")
    spec["per_layer"].append(dict(name="frames_traced.serve", unit="frames",
                                  better="higher", source="host_clock",
                                  layer="whole frame or step",
                                  moves="frames_per_s",
                                  workloads=["tiny_serve_b"]))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    after = _hashes(root)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {root / "BENCHMARK.json"}
    res = _run(root, "tiny_serve_b", trace=1)
    assert res["correct"] is True
    assert res["metrics"]["frames_traced.serve"]["value"] == res["attempted"]
    assert "pairs_per_frame.serve" in res["metrics"]


def test_sound_runs_are_correct(root):
    for w in ("tiny_serve", "tiny_qtrain"):
        res = _run(root, w)
        assert res["correct"] is True, res["checks"]
        assert res["failed"] == 0 and res["attempted"] >= 1


@pytest.mark.parametrize("workload", ["tiny_serve", "tiny_qtrain"])
def test_the_control_and_the_faults_fail_the_limits(root, workload):
    cell = cells.load(workload, root)
    readings = control.readings(cell, SEED, "cpu")
    assert set(readings) == ({"control"} if workload == "tiny_serve"
                             else {"control", "half_batch"})
    for kind, numbers in readings.items():
        over = [k for k, v in numbers.items() if v > cell.limits[k]["limit"]]
        assert over, (kind, numbers)


def _broken_frame(real):
    def frame(server, pose, device):
        out = real(server, pose, device)
        image = out.keep[0].clone()
        image[:8, :8] += 0.05
        out.keep = (image, *out.keep[1:])
        return out
    return frame


def _unchanged_state(real):
    def trainer(cell, inputs, device):
        tr = real(cell, inputs, device)
        step = tr.step

        def frozen(state, cam, gt, sh):
            keep = {k: p.detach().clone()
                    for k, p in state.model.trainable().items()}
            state, met = step(state, cam, gt, sh)
            with torch.no_grad():
                for k, p in state.model.trainable().items():
                    p.copy_(keep[k])
            return state, met
        tr.step = frozen
        return tr
    return trainer


def _half_batch(real):
    def loss(pred, gt, lam=0.2):
        rows = pred.shape[0] // 2
        return real(pred[:rows], gt[:rows], lam)
    return loss


@pytest.mark.parametrize("fault", ["frame_altered", "state_unchanged",
                                   "half_batch"])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, fault):
    from gaussiansplat_tpu_torch.train import trainer as program_trainer

    program = cells.program(cells.load("tiny_serve", root))
    if fault == "frame_altered":
        monkeypatch.setattr(program, "serve_call",
                            _broken_frame(program.serve_call))
        workload = "tiny_serve"
    elif fault == "state_unchanged":
        monkeypatch.setattr(program, "train_setup",
                            _unchanged_state(program.train_setup))
        workload = "tiny_qtrain"
    else:
        monkeypatch.setattr(program_trainer, "photometric_loss",
                            _half_batch(program_trainer.photometric_loss))
        workload = "tiny_qtrain"
    res = _run(root, workload)
    assert res["correct"] is False, res["checks"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")


@pytest.mark.gpu
def test_a_tiny_cell_on_the_card(root, cuda):
    res = _run(root, "tiny_serve", trace=1, device="cuda")
    assert res["correct"] is True, res["checks"]
    assert res["device"]["busy_s"] > 0
    assert "k1_roofline.serve" in res["metrics"]
