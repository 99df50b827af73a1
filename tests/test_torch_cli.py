"""The port's CLI end to end on the CPU: train a tiny synthetic scene, then
render and evaluate the exported PLY through the same entry points a user
runs; `--resume`; an unknown scene; a NeRF-synthetic directory; and the
quality run script at a tiny size."""

import json
import os

import numpy as np
import pytest

from test_torch_common import limit_torch_threads
from test_torch_scenes import _write_nerf

from gaussiansplat_tpu_torch import cli
from gaussiansplat_tpu_torch.examples import train_benchmark

limit_torch_threads()

TINY = ["--scene", "synthetic", "--synthetic-n", "64", "--synthetic-size",
        "64", "--sh-degree", "1", "--device", "cpu"]


def test_train_render_eval_roundtrip(tmp_path, capsys):
    out = str(tmp_path / "run")
    assert cli.main(["train", *TINY, "--iterations", "3", "--eval-every",
                     "2", "--out", out]) == 0
    ply = os.path.join(out, "point_cloud.ply")
    assert os.path.exists(ply)
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in rows if r.get("kind") == "eval"] == [2, 3]
    assert all(r["overflow"] == 0 for r in rows if "loss" in r)
    assert os.listdir(os.path.join(out, "ckpts")) == ["step_00000003"]
    assert sorted(os.listdir(os.path.join(out, "previews"))) == [
        "preview_000002.png", "preview_000003.png"]

    renders = str(tmp_path / "renders")
    assert cli.main(["render", "--ply", ply, "--out", renders, "--frames", "1",
                     "--width", "64", "--height", "64", "--fx", "60",
                     "--sh-degree", "1", "--device", "cpu"]) == 0
    assert any(f.startswith("frame_0000") for f in os.listdir(renders))

    capsys.readouterr()
    assert cli.main(["eval", *TINY, "--ply", ply]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["n_views"] == 4 and result["scene"] == "synthetic64"
    assert np.isfinite(result["psnr"]) and 0.0 < result["ssim"] <= 1.0


def test_resume_continues_past_last_step(tmp_path):
    out = str(tmp_path / "run")
    args = ["train", *TINY, "--no-previews", "--out", out]
    assert cli.main(args + ["--iterations", "2"]) == 0
    assert cli.main(args + ["--iterations", "4", "--resume"]) == 0
    assert sorted(os.listdir(os.path.join(out, "ckpts")))[-1] == "step_00000004"
    steps = [json.loads(line)["step"]
             for line in open(os.path.join(out, "metrics.jsonl"))]
    # each run logs its last step's train row and eval row
    assert steps == [2, 2, 4, 4]
    assert not os.path.exists(os.path.join(out, "previews"))


def test_bad_scene_exits():
    with pytest.raises(SystemExit):
        cli.main(["train", "--scene", "/nonexistent/path", "--device", "cpu"])


def test_defaults_run_on_the_card():
    p = cli.build_parser()
    for argv in (["train"], ["eval", "--ply", "x.ply"]):
        args = p.parse_args(argv)
        assert args.device == "cuda" and args.scene == "synthetic"
    assert p.parse_args(["train"]).iterations == 7000


def test_train_nerf_synthetic_dir(tmp_path):
    _write_nerf(tmp_path, size=32)
    out = str(tmp_path / "run")
    assert cli.main(["train", "--scene", str(tmp_path), "--n-init", "64",
                     "--capacity", "256", "--iterations", "2", "--sh-degree",
                     "1", "--device", "cpu", "--out", out,
                     "--eval-views", "1"]) == 0
    assert os.path.exists(os.path.join(out, "point_cloud.ply"))


def test_quality_run_small(tmp_path):
    out = str(tmp_path / "bench")
    cache = str(tmp_path / "gt.npz")
    argv = ["--iterations", "12", "--size", "32", "--n-points", "1500",
            "--init-points", "200", "--capacity", "1024", "--device", "cpu",
            "--out", out,
            "--gt-cache", cache]
    assert train_benchmark.main(argv) == 0
    result = json.load(open(os.path.join(out, "result.json")))
    for k in ("eval_psnr", "eval_ssim", "final_gaussians", "psnr_deg3",
              "gt_psnr_deg3", "scene_build_s", "wall_s", "step_ms_median"):
        assert np.isfinite(result[k]), k
    assert result["final_gaussians"] == 200 and not result["gt_cached"]
    assert os.path.exists(cache)
    assert train_benchmark.main(argv) == 0          # from the GT cache
    again = json.load(open(os.path.join(out, "result.json")))
    assert again["gt_cached"]
    np.testing.assert_allclose(again["gt_psnr_deg0"], result["gt_psnr_deg0"],
                               atol=0.05)


def _run_example(name, argv, monkeypatch):
    import runpy

    monkeypatch.setattr("sys.argv", [name, *argv])
    with pytest.raises(SystemExit) as exc:
        runpy.run_module(f"gaussiansplat_tpu_torch.examples.{name}",
                         run_name="__main__")
    return exc.value.code


@pytest.mark.parametrize("name", ["train_synthetic", "render_ply"])
def test_example_help(name, monkeypatch, capsys):
    assert _run_example(name, ["--help"], monkeypatch) == 0
    assert "--device" in capsys.readouterr().out


def test_examples_train_then_render(tmp_path, monkeypatch):
    out = str(tmp_path / "run")
    assert _run_example("train_synthetic", [
        "--synthetic-n", "64", "--synthetic-size", "64", "--sh-degree", "1",
        "--iterations", "2", "--device", "cpu", "--out", out,
        "--no-previews"], monkeypatch) == 0
    ply = os.path.join(out, "point_cloud.ply")
    renders = str(tmp_path / "renders")
    assert _run_example("render_ply", [
        "--ply", ply, "--out", renders, "--frames", "2", "--width", "64",
        "--height", "48", "--fx", "60", "--sh-degree", "1", "--device",
        "cpu"], monkeypatch) == 0
    assert sorted(f[:10] for f in os.listdir(renders)) == ["frame_0000",
                                                           "frame_0001"]
