"""The port's whole render slice on the CPU against the JAX reference.

`render(model, camera)` of gaussiansplat_tpu_torch (plain versions of the
kernels, device="cpu") against the reference's `render(impl="xla")` on the
scenes of tests/test_render.py at SH degree 3: image and transmittance
within the tests/imgcheck.py budget, num_pairs and overflow equal, radii
equal but for ULP-level ceil() flips (at most 0.1% of entries, by 1). Plus
the CLI, the import boundary of the port and its device rules.
"""

import ast
import inspect
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (
    assert_ints_close,
    limit_torch_threads,
    np_,
    port_camera,
    port_model,
)
from imgcheck import assert_images_close

from gaussiansplat_tpu.config import RasterConfig as JRasterConfig
from gaussiansplat_tpu.models import random_model as j_random_model
from gaussiansplat_tpu.ops import look_at as j_look_at
from gaussiansplat_tpu.ops import orbit_camera as j_orbit_camera
from gaussiansplat_tpu.render import render as _j_render
from gaussiansplat_tpu.utils import export_ply as j_export_ply
from gaussiansplat_tpu_torch import cli
from gaussiansplat_tpu_torch.config import RasterConfig
from gaussiansplat_tpu_torch.models import from_arrays, random_model
from gaussiansplat_tpu_torch.models.densify import DensifyState
from gaussiansplat_tpu_torch.ops.camera import look_at, make_camera
from gaussiansplat_tpu_torch.ops.kernels.backward import rasterize_backward_cuda
from gaussiansplat_tpu_torch.ops.kernels.expand import expand_pairs_cuda
from gaussiansplat_tpu_torch.ops.kernels.forward import rasterize_forward_cuda
from gaussiansplat_tpu_torch.ops.kernels.segreduce import segment_reduce_pairs_cuda
from gaussiansplat_tpu_torch.render import render
from gaussiansplat_tpu_torch.train import init_train_state, make_train_step
from gaussiansplat_tpu_torch.utils import import_ply

limit_torch_threads()

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "gaussiansplat_tpu_torch"

j_render = jax.jit(_j_render, static_argnames=("cfg", "sh_degree", "impl",
                                                "xla_max_chunks"))


def _scene(n=256, seed=0, width=128, height=128, eye=(0.5, 0.3, -6.0)):
    m = j_random_model(jax.random.PRNGKey(seed), n, sh_degree=3, extent=1.0)
    cam = j_look_at(eye=eye, target=(0, 0, 0), fx=220.0, fy=220.0,
                    width=width, height=height)
    return m, cam


def _compare(jm, jcam, bg, **cfg_kw):
    jo = j_render(jm, jcam, JRasterConfig(impl="xla", **cfg_kw), sh_degree=3,
                  background=jnp.asarray(bg), impl="xla")
    to = render(port_model(jm), port_camera(jcam), RasterConfig(**cfg_kw),
                sh_degree=3, background=torch.tensor(bg))
    assert tuple(to.image.shape) == tuple(jo.image.shape)
    assert int(to.num_pairs) == int(jo.num_pairs)
    assert int(to.overflow) == int(jo.overflow)
    assert int(jo.max_chunks_needed) <= 64  # the XLA twin truncates past 64
    assert int(to.max_chunks_needed) == int(jo.max_chunks_needed)
    assert_images_close(np_(to.image), np.asarray(jo.image))
    assert_images_close(np_(to.transmittance), np.asarray(jo.transmittance))
    assert_ints_close(np_(to.radii), np.asarray(jo.radii))
    return to, jo


@pytest.mark.parametrize("seed", [0, 1])
def test_render_matches_jax(seed):
    jm, jcam = _scene(seed=seed)
    to, _ = _compare(jm, jcam, np.array([0.1, 0.2, 0.3], np.float32))
    assert int(to.num_pairs) > 0


def test_render_nonsquare_matches_jax():
    jm, _ = _scene(n=128)
    jcam = j_look_at(eye=(0, 0, -6), target=(0, 0, 0), fx=200, fy=200,
                     width=100, height=72)
    to, _ = _compare(jm, jcam, np.zeros(3, np.float32))
    assert tuple(to.image.shape) == (72, 100, 3)


def test_render_small_chunks_and_overflow_match_jax():
    jm, jcam = _scene(n=256, seed=2)
    to, _ = _compare(jm, jcam, np.array([0.5, 0.0, 0.25], np.float32),
                     chunk_size=32, pairs_per_gaussian=0.5)
    assert int(to.overflow) > 0


def test_empty_scene_is_background():
    jm, jcam = _scene(n=4)
    jm = jm.replace(alive=jnp.zeros_like(jm.alive))
    to, _ = _compare(jm, jcam, np.array([0.25, 0.5, 0.75], np.float32))
    np.testing.assert_allclose(np_(to.image), np.broadcast_to(
        [0.25, 0.5, 0.75], to.image.shape), atol=1e-6)


def test_render_is_differentiable_on_cpu():
    jm, jcam = _scene(n=64, width=64, height=64)
    model = port_model(jm)
    out = render(model, port_camera(jcam))
    out.image.sum().backward()
    for name, p in model.trainable().items():
        assert torch.isfinite(p.grad).all(), name
    assert model.sh_dc.grad.abs().sum() > 0


def test_cli_round_trip(tmp_path):
    """The reference writes a PLY; the port's CLI renders it on the CPU; the
    frame equals the reference's render quantized to 8 bits."""
    jm, _ = _scene(n=256, seed=3)
    ply = str(tmp_path / "scene.ply")
    j_export_ply(ply, jm)
    out = tmp_path / "frames"
    rc = subprocess.run(
        [sys.executable, "-m", "gaussiansplat_tpu_torch", "render",
         "--device", "cpu", "--ply", ply, "--out", str(out), "--frames", "1",
         "--width", "128", "--height", "96", "--fx", "220", "--radius", "6"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert rc.returncode == 0, rc.stderr
    from PIL import Image

    frame = np.asarray(Image.open(out / "frame_0000.png")).astype(np.int64)
    jcam = j_orbit_camera(0.0, 6.0, height_offset=1.0, fx=220.0, fy=220.0,
                          width=128, height=96)
    jo = j_render(jm, jcam, JRasterConfig(impl="xla"), sh_degree=3,
                  background=jnp.zeros(3), impl="xla")
    want = (np.clip(np.asarray(jo.image), 0, 1) * 255).astype(np.int64)
    d = np.abs(frame - want)
    assert frame.shape == (96, 128, 3) and frame.max() > 0
    # 8-bit truncation moves a value by one level where the two sides
    # straddle a level boundary; a gate flip (<= 2.5/255) by up to 3.
    assert d.max() <= 3 and (d > 1).sum() <= 24 and (d > 0).mean() < 0.01


def test_import_leaves_no_jax():
    code = (
        "import pkgutil, sys, importlib, gaussiansplat_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'gaussiansplat_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    rc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                        capture_output=True, text=True, timeout=120)
    assert rc.returncode == 0, rc.stderr


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "compare_forward_builds.py"]
    assert len(files) > 15
    scanned = {f.relative_to(PKG).as_posix() for f in files if PKG in f.parents}
    assert {f"parallel/{m}.py" for m in ("gauss_shard", "gauss_train",
                                         "depth_ring", "gauss2d", "multihost",
                                         "capacity")} | {"utils/comm_bytes.py"} \
        <= scanned
    for f in files:
        bad = {"jax", "jaxlib", "flax", "gaussiansplat_tpu"} & set(
            _imported_roots(f))
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"


def test_cuda_paths_refuse_cpu_tensors():
    m = random_model(torch.Generator().manual_seed(0), 64, device="cpu")
    cam = look_at((0, 0, -6), (0, 0, 0), fx=100.0, fy=100.0, width=64,
                  height=64, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        render(m, cam, RasterConfig(impl="cuda"))
    i32 = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        expand_pairs_cuda(i32, i32, i32, i32[0], 512, 2, 4, 2, (1, 2, 1), True)
    with pytest.raises(ValueError, match="CUDA"):
        rasterize_forward_cuda(torch.zeros((8, 16)), torch.zeros(5, dtype=torch.int32),
                               64, 64, RasterConfig())
    blocks = torch.zeros((4, 8, 1024))
    with pytest.raises(ValueError, match="CUDA"):
        rasterize_backward_cuda(torch.zeros((8, 16)), torch.zeros(5, dtype=torch.int32),
                                blocks, blocks, 64, 64, RasterConfig())
    with pytest.raises(ValueError, match="CUDA"):
        segment_reduce_pairs_cuda(torch.zeros((8, 16)), torch.zeros(3, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="impl"):
        render(m, cam, RasterConfig(impl="pallas"))


def _render_paths():
    """Each render path of the port, as a call on a CPU scene with a given
    RasterConfig: `render`, a tile strip, the gaussian axis's strip and the
    depth ring on a mesh of one rank, and 2D splats."""
    from gaussiansplat_tpu_torch.models.splats2d import (
        random_splats2d, render_splats2d)
    from gaussiansplat_tpu_torch.parallel import make_gauss_mesh, render_strip
    from gaussiansplat_tpu_torch.parallel.depth_ring import render_depth_ring
    from gaussiansplat_tpu_torch.parallel.gauss_shard import (
        render_gauss_sharded_strip)

    g = torch.Generator().manual_seed(0)
    m = random_model(g, 64, sh_degree=1, device="cpu")
    splats = random_splats2d(g, 64, 64, 64, device="cpu")
    cam = look_at((0, 0, -6), (0, 0, 0), fx=100.0, fy=100.0, width=64,
                  height=64, device="cpu")
    bg = torch.zeros(3)
    mesh = make_gauss_mesh()
    return {
        "render": lambda cfg: render(m, cam, cfg),
        "tile_strip": lambda cfg: render_strip(m, cam, cfg, 1, bg, 0, 2, 1024),
        "gauss_strip": lambda cfg: render_gauss_sharded_strip(
            m, cam, cfg, 1, bg, [0, 2], 64, mesh),
        "depth_ring": lambda cfg: render_depth_ring(m, cam, cfg, 1, bg, 1, 64,
                                                    mesh),
        "splats2d": lambda cfg: render_splats2d(splats, 64, 64, cfg),
    }


@pytest.mark.parametrize("path", ["render", "tile_strip", "gauss_strip",
                                  "depth_ring", "splats2d"])
def test_every_render_path_follows_cfg_impl(path):
    """`RasterConfig.impl` is the one backend switch of every render path:
    'cuda' refuses CPU tensors, 'auto' and 'torch' render them alike."""
    run = _render_paths()[path]
    with pytest.raises(ValueError, match="CUDA"):
        run(RasterConfig(impl="cuda"))
    auto, plain = run(RasterConfig()), run(RasterConfig(impl="torch"))
    auto = auto.image if hasattr(auto, "image") else auto[0]
    plain = plain.image if hasattr(plain, "image") else plain[0]
    assert bool(auto.any()) and torch.equal(auto, plain)


def test_entry_points_default_to_cuda():
    for fn in (random_model, from_arrays, import_ply, look_at, make_camera,
               DensifyState.zeros):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    # The train state and step run on the device of the model they get.
    for fn in (init_train_state, make_train_step):
        assert "device" not in inspect.signature(fn).parameters, fn
    args = cli.build_parser().parse_args(["render", "--ply", "x.ply"])
    assert args.device == "cuda"
