"""Port parity of the model constructors and the PLY / cameras.json IO
against the JAX reference (CPU)."""

import jax
import numpy as np
import torch

from test_torch_common import limit_torch_threads, np_, port_model

from gaussiansplat_tpu.data.cameras import load_cameras_json as j_load_cams
from gaussiansplat_tpu.data.cameras import save_cameras_json as j_save_cams
from gaussiansplat_tpu.models import random_model as j_random_model
from gaussiansplat_tpu.models.gaussians import from_arrays as j_from_arrays
from gaussiansplat_tpu.models.gaussians import scene_extent as j_scene_extent
from gaussiansplat_tpu.ops import look_at as j_look_at
from gaussiansplat_tpu.utils import export_ply as j_export_ply
from gaussiansplat_tpu.utils import import_ply as j_import_ply
from gaussiansplat_tpu_torch.data.cameras import load_cameras_json
from gaussiansplat_tpu_torch.models import (
    empty_model,
    from_arrays,
    random_model,
    scene_extent,
)
from gaussiansplat_tpu_torch.utils import export_ply, import_ply

limit_torch_threads()

PARAMS = ("means", "quats", "log_scales", "logit_opacities", "sh_dc", "sh_rest")


def _arrays(n=40, k=16, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return f(n, 3), f(n, 4), f(n, 3), f(n), f(n, 1, 3), f(n, k - 1, 3)


def test_from_arrays_matches_jax():
    arrs = _arrays()
    jm = j_from_arrays(*arrs, capacity=64)
    tm = from_arrays(*arrs, capacity=64, device="cpu")
    for k in PARAMS:
        np.testing.assert_array_equal(np_(getattr(tm, k)),
                                      np.asarray(getattr(jm, k)), err_msg=k)
    np.testing.assert_array_equal(np_(tm.alive), np.asarray(jm.alive))
    assert tm.sh_degree == 3 and tm.capacity == 64


def test_random_and_empty_model():
    g = torch.Generator().manual_seed(0)
    m = random_model(g, 100, sh_degree=2, capacity=128, opacity=0.8,
                     scale_range=(0.1, 0.2), device="cpu")
    assert m.capacity == 128 and m.sh_degree == 2
    assert int(m.alive.sum()) == 100 and not m.alive[100:].any()
    assert m.means.abs().max() <= 1.0
    np.testing.assert_allclose(np_(torch.sigmoid(m.logit_opacities[:100])),
                               0.8, rtol=1e-6)
    s = np_(torch.exp(m.log_scales[:100]))
    assert s.min() >= 0.1 - 1e-6 and s.max() <= 0.2 + 1e-6
    e = empty_model(8, sh_degree=1, device="cpu")
    assert e.sh_rest.shape == (8, 9) and not e.alive.any()
    assert set(dict(m.named_parameters())) == set(PARAMS)


def test_scene_extent_matches_jax():
    jm = j_random_model(jax.random.PRNGKey(1), 50, capacity=64)
    jm = jm.replace(alive=jm.alive.at[::7].set(False))
    np.testing.assert_allclose(float(scene_extent(port_model(jm))),
                               float(j_scene_extent(jm)), rtol=1e-6)


def test_ply_round_trip_both_ways(tmp_path):
    jm = j_random_model(jax.random.PRNGKey(2), 30, sh_degree=3, capacity=40)
    # reference writes, port reads
    j_export_ply(str(tmp_path / "a.ply"), jm)
    tm = import_ply(str(tmp_path / "a.ply"), device="cpu")
    for k in PARAMS:
        np.testing.assert_array_equal(np_(getattr(tm, k)),
                                      np.asarray(getattr(jm, k))[:30], err_msg=k)
    # port writes (alive gaussians only), reference reads
    assert export_ply(str(tmp_path / "b.ply"), port_model(jm)) == 30
    jm2 = j_import_ply(str(tmp_path / "b.ply"))
    for k in PARAMS:
        np.testing.assert_array_equal(np.asarray(getattr(jm2, k)),
                                      np.asarray(getattr(jm, k))[:30], err_msg=k)


def test_cameras_json_matches_jax(tmp_path):
    cams = [j_look_at(eye=(1.0 * i, 0.5, -4.0), target=(0, 0, 0), fx=300.0,
                      fy=280.0, width=160, height=120) for i in range(3)]
    path = str(tmp_path / "cameras.json")
    j_save_cams(path, cams)
    for tc, jc in zip(load_cameras_json(path, device="cpu"), j_load_cams(path)):
        for f in ("R", "t", "fx", "fy", "cx", "cy"):
            np.testing.assert_allclose(np_(getattr(tc, f)),
                                       np.asarray(getattr(jc, f)), atol=1e-6)
        assert (tc.width, tc.height) == (jc.width, jc.height)
