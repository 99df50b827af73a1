"""Shared helpers (no tests here) for the port's parity tests: hand the
same inputs, as numpy, from the JAX reference package to the PyTorch port
(on the CPU)."""

import os

import numpy as np
import torch

from gaussiansplat_tpu_torch.models import from_numpy_params
from gaussiansplat_tpu_torch.ops.camera import camera_from_numpy
from gaussiansplat_tpu_torch.ops.projection import Projected


def limit_torch_threads():
    """Under pytest-xdist, give this worker its share of the CPU's cores as
    torch intra-op threads (at least one): every worker runs beside the
    others, and a pool of one thread a core in each of them makes them
    fight over the cores. Outside xdist, torch's default stands."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(workers)))


PROJ_FIELDS = ("mean2d", "depth", "conic", "rgb", "opacity", "radius",
               "radius_xy", "valid")


def port_model(jax_model, device="cpu"):
    params = {k: np.asarray(v) for k, v in jax_model.trainable().items()}
    return from_numpy_params(params, np.asarray(jax_model.alive), device=device)


def port_camera(cam, device="cpu"):
    return camera_from_numpy(np.asarray(cam.R), np.asarray(cam.t), cam.fx,
                             cam.fy, cam.cx, cam.cy, cam.width, cam.height,
                             device=device)


def port_projected(jproj):
    return Projected(**{f: torch.as_tensor(np.array(getattr(jproj, f)))
                        for f in PROJ_FIELDS})


def np_(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_ints_close(got, want, frac=1e-3):
    """Integer fields from ceil() of transcendental results: XLA and PyTorch
    may round those an ULP apart, so at most `frac` of the entries may
    differ, each by at most 1."""
    d = np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64))
    assert d.max(initial=0) <= 1, f"integer field off by {d.max()}"
    assert (d > 0).mean() <= frac, f"{(d > 0).mean():.3%} of entries differ"
