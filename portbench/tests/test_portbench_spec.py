"""BENCHMARK.json against the benchmark's contract: names, units, keys,
bounds, the files each entry names, and what every cell reports."""

import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_sizes():
    assert set(SPEC) == KEYS["top"]
    assert len(json.dumps(SPEC).encode()) <= 64 * 1024
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert 1 <= len(SPEC["configs"]) <= 24
    assert 1 <= len(SPEC["workloads"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16
    assert 1 <= len(SPEC["per_layer"]) <= 128
    for p in SPEC["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_entries(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for e in SPEC[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.fullmatch(e["name"]), e["name"]
        for k in ("why", "layer"):
            if k in e:
                assert _line(e[k]), (e["name"], k)
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES


def test_configs_and_files():
    for c in SPEC["configs"]:
        f = REPO / c["file"]
        assert f.is_file() and c["file"].startswith("portbench/")
        cfg = json.loads(f.read_text())
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.fullmatch(k)
            assert not re.search(r"(_dim|_rank)$|hidden|width|size", k), k
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"] and _line(c["source"])
    assert len({c["file"] for c in SPEC["configs"]}) == len(SPEC["configs"])


def test_cells():
    configs = {c["name"] for c in SPEC["configs"]}
    used = set()
    pairs = set()
    e2e = SPEC["end_to_end"]
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in e2e)
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    for w in SPEC["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.fullmatch(w["traffic"]) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        assert (REPO / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (REPO / "portbench" / "limits" / f"{w['name']}.json").is_file()
        mine = [m["name"] for m in e2e
                if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in mine and len(mine) >= 2, w["name"]
        layer = [m for m in SPEC["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        assert layer, w["name"]
        for m in layer:
            assert m["moves"] in mine, (w["name"], m["name"])
    assert used == configs


def test_metrics():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert (REPO / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    # the whole step's share of the peak beside the kernels' rooflines
    for kind in ("serve", "train"):
        assert f"mfu.{kind}" in {m["name"] for m in SPEC["per_layer"]}
