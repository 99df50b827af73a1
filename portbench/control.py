"""Readings that set the limits' upper ends: the control and the faults,
each put in the program's place and compared by judge.py as a run would
compare the program. The cell's program file (`control`) gives them; for
gauss3d:

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

from . import cells, inputs as inputs_mod


def readings(cell, seed: int, device) -> Dict[str, Dict[str, float]]:
    program = cells.program(cell)
    inp = inputs_mod.make(cell, program, seed, device)
    return program.control(cell, inp, seed, device)


def worst(per_seed: List[Dict[str, Dict[str, float]]]) -> Dict[str, Dict[str, float]]:
    """The smallest reading of each number of each control or fault over
    the seeds: the upper end it can set."""
    out: Dict[str, Dict[str, float]] = {}
    for r in per_seed:
        for kind, nums in r.items():
            for k, v in nums.items():
                out.setdefault(kind, {})[k] = min(v, out.get(kind, {}).get(k, v))
    return out
