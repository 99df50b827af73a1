"""Readings that set the limits' upper ends: the control and the faults,
each put in the program's place and compared by judge.py as a run would
compare the program.

- The control: the reference with the raster payload (centre, conic,
  opacity, colour) rounded to bfloat16, the nearest precision below the
  configuration's float32 and the step a later change would be tempted by
  (the payload gather is the largest cost of a frame).
- A training step whose loss leaves out the bottom half of the image
  ('half of the batch left out, the mean taken over the rest').
- A step that returns its state unchanged reads change_gap = 1 by the
  measure itself and needs no run.

On the chip at each cell's size, over several seeds: portbench/readings.py.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import inputs as inputs_mod, judge
from .reference import render as R
from .reference import train as ref_train


def serve_readings(cell, inp: inputs_mod.Inputs, seed: int,
                   device) -> Dict[str, Dict[str, float]]:
    """The control's numbers on `compare_frames` poses drawn from the seed
    among the first 256 of the cell's request sequence."""
    rc = R.Raster.from_dict(cell.config["raster"])
    rng = np.random.default_rng(inputs_mod.sub_seed(seed, 6))
    idx = rng.choice(min(256, len(inp.poses)), cell.traffic["compare_frames"],
                     replace=False)
    frames = []
    with R.fp32_math():
        for i in sorted(idx.tolist()):
            cam = inputs_mod.ref_camera(inp.poses[i], device)
            proj = R.project(inp.params, inp.alive, cam, rc, inp.sh_degree)
            ri, rt, _ = R.render(proj, cam, rc, inp.background)
            bf = R.round_fields(proj["fields"], torch.bfloat16)
            ci, ct, _ = R.render(proj, cam, rc, inp.background, fields=bf)
            frames.append((ci, ct, ri, rt))
    return dict(control=judge.serve_numbers(frames))


def train_readings(cell, inp: inputs_mod.Inputs,
                   device) -> Dict[str, Dict[str, float]]:
    """The control's and the half-batch fault's numbers on the cell's first
    steps."""
    rc = R.Raster.from_dict(cell.config["raster"])
    steps = cell.traffic["follow_steps"]
    views = [(inputs_mod.ref_camera(inp.poses[v], device), inp.targets[v],
              inp.background) for v in inp.order[:steps]]
    run = lambda **kw: ref_train.follow(inp.params, inp.alive, views, rc,
                                        cell.config["train"], inp.sh_degree,
                                        inp.extent, steps, **kw)
    want = run()
    return dict(control=judge.train_numbers(run(payload_dtype=torch.bfloat16),
                                            want),
                half_batch=judge.train_numbers(run(half_batch=True), want))


def readings(cell, seed: int, device) -> Dict[str, Dict[str, float]]:
    inp = inputs_mod.make(cell, seed, device)
    if cell.traffic["kind"] == "serve":
        return serve_readings(cell, inp, seed, device)
    return train_readings(cell, inp, device)


def worst(per_seed: List[Dict[str, Dict[str, float]]]) -> Dict[str, Dict[str, float]]:
    """The smallest reading of each number of each control or fault over
    the seeds: the upper end it can set."""
    out: Dict[str, Dict[str, float]] = {}
    for r in per_seed:
        for kind, nums in r.items():
            for k, v in nums.items():
                out.setdefault(kind, {})[k] = min(v, out.get(kind, {}).get(k, v))
    return out
