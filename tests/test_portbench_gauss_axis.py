"""The gaussian-axis program file of the benchmark
(portbench/programs/gauss_axis.py) at a tiny size on gloo ranks, in a
copy of the benchmark (portbench/tests/tiny.py) that gains a cell of it
as new files:

  * the training cell on 4 ranks over uneven strips (10 tile rows: 3, 3,
    2, 2), traced, through `run.py`: correct, `grad_block_gap` among the
    checks, the exchange's fill among the metrics;
  * the scene turned so that the orbit's views meet the cube face on;
  * the control and the faults (`control.py`, in one process) against the
    cell's limits: the bfloat16 payload and every fault over at least one,
    the gradient blocks handed to the next rank over `grad_block_gap`;
  * a `send_fraction` too small for the scene fails the run in its
    warm-up, with the reason last on standard error;
  * the cell's reference (portbench/reference/sharded_train.py), which
    composites each tile only up to its early exit, against render.py's
    whole lists.
Each run of `run.py` is a process of its own, under a limit of LIMIT_S.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "portbench" / "tests"))

from tiny import make_root  # noqa: E402
from test_torch_common import limit_torch_threads  # noqa: E402

limit_torch_threads()

SEED = 4294967311
LIMIT_S = 150
LIKE = "train_32m_1080p_gauss4"
# name: (chips, traffic height, send_fraction)
CELLS = {"tiny_axis_train": (4, 160, 1.0), "tiny_axis_drops": (2, 48, 0.05)}


def _json(path, obj):
    path.write_text(json.dumps(obj, indent=1))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = make_root(tmp_path_factory.mktemp("checkout"))
    pb = root / "portbench"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    full = json.loads((REPO / "BENCHMARK.json").read_text())
    scene = json.loads((pb / "configs" / "tiny_scene.json").read_text())
    views = json.loads((pb / "traffic" / "tiny_views.json").read_text())
    for name, (chips, height, fraction) in CELLS.items():
        _json(pb / "configs" / f"{name}.json",
              dict(scene, program="gauss_axis", send_fraction=fraction))
        _json(pb / "traffic" / f"{name}.json", dict(views, height=height))
        shutil.copy(pb / "limits" / f"{LIKE}.json",
                    pb / "limits" / f"{name}.json")
        spec["configs"].append(dict(name=name, source="tiny",
                                    file=f"portbench/configs/{name}.json",
                                    reduced=[], why="tiny"))
        spec["workloads"].append(dict(name=name, config=name, traffic=name,
                                      chips=chips, why="tiny"))
    metrics = {m["name"]: m for m in spec["end_to_end"] + spec["per_layer"]}
    for m in full["end_to_end"] + full["per_layer"]:
        if LIKE in m.get("workloads", []):
            if m["name"] not in metrics:
                spec["per_layer"].append(dict(m, workloads=[]))
                metrics[m["name"]] = spec["per_layer"][-1]
            metrics[m["name"]]["workloads"] += list(CELLS)
    _json(root / "BENCHMARK.json", spec)
    return root


def _run(root, workload, trace):
    script = (f"import sys; from pathlib import Path; "
              f"sys.path[:0] = [{str(REPO)!r}]; from portbench import run; "
              f"sys.exit(run.main(['--workload', {workload!r}, '--seed', "
              f"'{SEED}', '--seconds', '0.3', '--trace', '{trace}'], "
              f"root=Path({str(root)!r}), device='cpu'))")
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=LIMIT_S, cwd=REPO)
    return p.returncode, p.stdout, p.stderr


def test_the_cell_on_four_ranks(root):
    rc, out, err = _run(root, "tiny_axis_train", 1)
    assert rc == 0, err[-4000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["count"] == 4
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                  "grad_block_gap", "overflow_calls",
                                  "nonfinite_calls"}
    # Off CUDA the device times read nothing; the counters do.
    assert 0 < res["metrics"]["send_fill.train"]["value"] <= 100
    assert 0 < res["metrics"]["slot_fill.train"]["value"] <= 100
    assert "exchange_ms.train" not in res["metrics"]


def test_control_and_faults_over_the_limits(root):
    sys.path.insert(0, str(REPO))
    from portbench import cells, control

    cell = cells.load("tiny_axis_train", root)
    got = control.readings(cell, SEED, "cpu")
    assert set(got) == {"control", "half_batch", "block_left_out",
                        "blocks_rolled"}
    limits = cell.limits
    for kind, nums in got.items():
        over = [k for k, v in nums.items() if v > limits[k]["limit"]]
        assert over, (kind, nums)
    assert got["blocks_rolled"]["grad_block_gap"] > limits["grad_block_gap"]["limit"]


@pytest.mark.parametrize("seed", [SEED, 4200000011])
def test_the_views_meet_the_cube_face_on(root, seed):
    """Every view of the orbit that portbench/inputs.py draws looks at a
    face of the cube of centres: along the view's
    horizontal axes the centres fill [-1, 1], as they would not at the
    seed's own angle (18 degrees off a face for the second seed)."""
    import math

    import torch

    sys.path.insert(0, str(REPO))
    from portbench import cells, inputs

    cell = cells.load("tiny_axis_train", root)
    inp = inputs.make(cell, cells.program(cell), seed, "cpu")
    x, _, z = inp.params["means"].unbind(-1)
    for pose in inp.poses:
        eye = -pose.R.T @ pose.t
        a = math.atan2(eye[0], eye[2])
        for u in (x * math.sin(a) + z * math.cos(a),
                  x * math.cos(a) - z * math.sin(a)):
            assert 0.99 < float(u.abs().max()) <= 1 + 1e-5
    assert torch.equal(inp.params["quats"],
                       cells.program(cell).gauss3d.scene(
                           cell.config, seed, "cpu")[0]["quats"])


def test_dropped_payload_rows_fail_the_warmup(root):
    rc, out, err = _run(root, "tiny_axis_drops", 0)
    assert rc != 0 and not out.strip()
    assert "send_fraction 0.05 is too small" in err.strip().splitlines()[-1]


def test_reference_exits_as_render_py():
    """reference/sharded_train.py composites each tile only up to its early
    exit; on a scene dense enough that most binned pairs lie past it, the
    image (over a background, so the transmittance too), the counts and
    the raster fields' gradient are render.py's, which composites whole
    lists."""
    import torch

    sys.path.insert(0, str(REPO))
    from portbench import inputs
    from portbench.reference import render as R
    from portbench.reference import scenes, sharded_train

    w, h, fx = 64, 48, 53.3
    cfg = json.loads((REPO / "portbench" / "configs" / "scene_32m_sh3.json")
                     .read_text())
    rc = R.Raster.from_dict(dict(cfg["raster"], tile_size=16))
    params, alive = scenes.bench_scene(3, 40000, 3, 0.8, (0.004, 0.012), w, h,
                                       fx, 0.05, "cpu")
    rot, t = scenes.look_at(scenes.orbit_eye(0.4, 0.0, 4.0), (0, 0, 0),
                            (0, 1, 0))
    cam = inputs.ref_camera(inputs.Pose(R=rot, t=t, fx=fx, fy=fx,
                                        cx=(w - 1) / 2, cy=(h - 1) / 2,
                                        width=w, height=h), "cpu")
    bg = torch.tensor([0.1, 0.2, 0.3])
    proj = R.project(params, alive, cam, rc, 3)
    img, trans, cnt = R.render(proj, cam, rc, bg, count=True)
    b = R.bin_pairs(proj, cam, rc)
    assert cnt.pairs < 0.5 * b.gauss.numel()
    got, got_cnt, used = sharded_train.render(proj["fields"], b, cam, rc, bg,
                                              True, None)
    torch.testing.assert_close(got, img, atol=2e-6, rtol=0)
    assert (got_cnt.pairs, got_cnt.inside, got_cnt.live) == (
        cnt.pairs, cnt.inside, cnt.live)
    dimg = torch.randn(img.shape, generator=torch.Generator().manual_seed(1))
    want = R.raster_backward(proj, proj["fields"], cam, rc, dimg, bg)
    grad = sharded_train.raster_backward(proj["fields"], b, cam, rc, dimg, bg,
                                         None, used)
    torch.testing.assert_close(grad, want, atol=1e-5 * float(want.abs().max()),
                               rtol=0)
