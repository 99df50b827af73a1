"""A checkout-shaped copy of the benchmark with tiny cells for the CPU:
BENCHMARK.json and portbench/'s data and program files, with three cells
cut to a few
thousand gaussians at 48-64 pixels (16 px tiles). The harness's code is
imported from the repository; only the data is the copy's. The quality
scene's configuration, traffic and limits files are not in BENCHMARK.json
(PERF.md, Open questions); `tiny_qtrain` is cut from them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

CELLS = {
    # name: (config, traffic, the cell whose metrics it reports, the limits
    # file it takes; the quality scene's are kept beside the benchmark's)
    "tiny_serve": ("tiny_scene", "tiny_orbit", "serve_3m_1080p_orbit",
                   "serve_3m_1080p_orbit"),
    "tiny_train": ("tiny_scene", "tiny_views", "train_3m_1080p_views",
                   "train_3m_1080p_views"),
    "tiny_qtrain": ("tiny_quality", "tiny_qviews", "train_3m_1080p_views",
                    "train_quality_800_start"),
}


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def make_root(dest: Path) -> Path:
    """Build the copy under `dest`; returns it."""
    pb = dest / "portbench"
    for sub in ("configs", "traffic", "limits", "metrics", "programs"):
        shutil.copytree(REPO / "portbench" / sub, pb / sub)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = lambda name: json.loads((pb / "configs" / f"{name}.json").read_text())
    tr = lambda name: json.loads((pb / "traffic" / f"{name}.json").read_text())

    scene = cfg("scene_3m_sh3")
    scene["scene"].update(n=1500, sizing=dict(width=64, height=48, fx=60.0))
    quality = cfg("quality_150k_800")
    quality["scene"].update(init_points=400, capacity=1024)
    quality["ground_truth"]["n_points"] = 2000
    quality["train_views"] = 4
    for c in (scene, quality):
        c["raster"].update(tile_size=16, chunk_size=32)
    _write(pb / "configs" / "tiny_scene.json", scene)
    _write(pb / "configs" / "tiny_quality.json", quality)

    orbit = tr("orbit_1080p")
    orbit.update(width=64, height=48, fx=60.0, poses=32)
    views = tr("orbit_views_1080p")
    views.update(width=64, height=48, fx=60.0)
    qviews = tr("quality_views_800")
    qviews.update(width=48, height=48)
    _write(pb / "traffic" / "tiny_orbit.json", orbit)
    _write(pb / "traffic" / "tiny_views.json", views)
    _write(pb / "traffic" / "tiny_qviews.json", qviews)

    spec["configs"] += [
        dict(name=n, source="tiny", file=f"portbench/configs/{n}.json",
             reduced=[], why="tiny")
        for n in ("tiny_scene", "tiny_quality")]
    spec["workloads"] = [dict(name=n, config=c, traffic=t, chips=1, why="tiny")
                         for n, (c, t, _, _) in CELLS.items()]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [n for n, (_, _, like, _) in CELLS.items()
                              if like in m["workloads"]]
    _write(dest / "BENCHMARK.json", spec)
    for n, (_, _, _, limits) in CELLS.items():
        shutil.copy(pb / "limits" / f"{limits}.json", pb / "limits" / f"{n}.json")
    return dest
