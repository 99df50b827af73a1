"""Port parity of the oracles, the scenes, the loaders and the PNG writer
on the CPU, against the reference package on the same numpy inputs.

* `render_oracle` (a pixel-chunked log-space cumulative sum here, a scan
  over the gaussians there): image and transmittance within 1e-5; the
  gradients of a seeded linear function of both outputs w.r.t. mean2d,
  conic, rgb, opacity and background within 1e-4 of each group's largest
  entry. `render_oracle_full` within 1e-5. The port's plain tiled
  `render()` against the port's oracle with the bounds of
  tests/test_render.py `test_forward_matches_oracle`.
* `synthetic_scene`'s views (cameras and oracle GT of the reference's GT
  model), `make_gt_model`, `hemisphere_cameras`, `benchmark_scene` (GT
  within 1e-5, init model equal) and `from_points`.
* The NeRF-synthetic and COLMAP loaders on the fixture files of
  tests/test_data.py: the same cameras and images.
* `write_png`: the same bytes.
"""

import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import np_, port_camera, port_model, port_projected

from gaussiansplat_tpu.config import RasterConfig as JRasterConfig
from gaussiansplat_tpu.data import benchmark as j_benchmark
from gaussiansplat_tpu.data import datasets as j_datasets
from gaussiansplat_tpu.data.colmap import read_colmap_model as j_read_colmap_model
from gaussiansplat_tpu.models import from_points as j_from_points
from gaussiansplat_tpu.models import random_model as j_random_model
from gaussiansplat_tpu.ops import look_at as j_look_at
from gaussiansplat_tpu.ops import oracle as j_oracle
from gaussiansplat_tpu.ops import project_gaussians as j_project
from gaussiansplat_tpu.utils import image as j_image
from gaussiansplat_tpu_torch.config import RasterConfig
from gaussiansplat_tpu_torch.data import benchmark, datasets
from gaussiansplat_tpu_torch.data.colmap import read_colmap_model
from gaussiansplat_tpu_torch.models import from_points
from gaussiansplat_tpu_torch.models.gaussians import PARAM_NAMES
from gaussiansplat_tpu_torch.ops.oracle import render_oracle, render_oracle_full
from gaussiansplat_tpu_torch.render import render
from gaussiansplat_tpu_torch.utils import image

JCFG = JRasterConfig(tile_size=32, chunk_size=128, impl="xla", packed=False)
CFG = RasterConfig(tile_size=32, chunk_size=128)
PROJ_GRAD_FIELDS = ("mean2d", "conic", "rgb", "opacity")


def _scene(seed=0, n=256, width=64, height=48):
    jm = j_random_model(jax.random.PRNGKey(seed), n, sh_degree=1, extent=1.0)
    jcam = j_look_at(eye=(0.5, 0.3, -6.0), target=(0, 0, 0), fx=110.0,
                     fy=110.0, width=width, height=height)
    jproj = jax.jit(lambda m, c: j_project(
        m.means, m.quats, m.log_scales, m.logit_opacities, m.sh, c, JCFG,
        sh_degree=1, alive=m.alive))(jm, jcam)
    return jm, jcam, jproj


def _assert_models_equal(tm, jm, atol=0.0):
    np.testing.assert_array_equal(np_(tm.alive), np.asarray(jm.alive))
    for k in PARAM_NAMES:
        np.testing.assert_allclose(np_(getattr(tm, k)), np.asarray(getattr(jm, k)),
                                   rtol=0, atol=atol, err_msg=k)


def _assert_cameras_equal(tc, jc):
    assert (tc.width, tc.height) == (jc.width, jc.height)
    for f in ("R", "t", "fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(np_(getattr(tc, f)), np.asarray(getattr(jc, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("respect_tiles", [True, False])
def test_render_oracle_matches_jax(respect_tiles):
    _, jcam, jproj = _scene(seed=1)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jimg, jtrans = jax.jit(
        j_oracle.render_oracle,
        static_argnames=("width", "height", "cfg", "respect_tiles"))(
        jproj, jcam.width, jcam.height, JCFG, jnp.asarray(bg),
        respect_tiles=respect_tiles)
    img, trans = render_oracle(port_projected(jproj), jcam.width, jcam.height,
                               CFG, torch.tensor(bg), respect_tiles=respect_tiles,
                               pixel_chunk=1000)
    np.testing.assert_allclose(np_(img), np.asarray(jimg), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np_(trans), np.asarray(jtrans), rtol=0, atol=1e-5)
    assert float(np_(trans).min()) < 0.5   # the scene covers pixels


def test_render_oracle_gradients_match_jax():
    _, jcam, jproj = _scene(seed=2)
    w, h = jcam.width, jcam.height
    rng = np.random.default_rng(7)
    ct_img = rng.normal(size=(h, w, 3)).astype(np.float32)
    ct_trans = rng.normal(size=(h, w)).astype(np.float32)
    bg = np.array([0.2, 0.1, 0.4], np.float32)

    def j_fn(fields, bg_):
        p = jproj.replace(**fields)
        img, trans = j_oracle.render_oracle(p, w, h, JCFG, bg_)
        return jnp.sum(img * ct_img) + jnp.sum(trans * ct_trans)

    jfields = {f: getattr(jproj, f) for f in PROJ_GRAD_FIELDS}
    jg, jg_bg = jax.jit(jax.grad(j_fn, argnums=(0, 1)))(jfields, jnp.asarray(bg))

    proj = port_projected(jproj)
    for f in PROJ_GRAD_FIELDS:
        getattr(proj, f).requires_grad_(True)
    tbg = torch.tensor(bg, requires_grad=True)
    img, trans = render_oracle(proj, w, h, CFG, tbg, pixel_chunk=1000)
    ((img * torch.tensor(ct_img)).sum() + (trans * torch.tensor(ct_trans)).sum()
     ).backward()
    groups = {f: (getattr(proj, f).grad, jg[f]) for f in PROJ_GRAD_FIELDS}
    groups["background"] = (tbg.grad, jg_bg)
    for name, (got, want) in groups.items():
        want = np.asarray(want, np.float64)
        scale = np.abs(want).max()
        assert scale > 0, name
        np.testing.assert_allclose(np_(got) / scale, want / scale, rtol=0,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("seed", [0, 3])
def test_render_oracle_full_matches_jax(seed):
    _, jcam, jproj = _scene(seed=seed, n=384)
    bg = np.array([0.3, 0.0, 0.1], np.float32)
    jimg, jtrans = jax.jit(
        j_oracle.render_oracle_full,
        static_argnames=("width", "height", "cfg", "pixel_chunk"))(
        jproj, jcam.width, jcam.height, JCFG, jnp.asarray(bg))
    # bands of one and of several rows
    for chunk in (64, 700):
        img, trans = render_oracle_full(port_projected(jproj), jcam.width,
                                        jcam.height, CFG, torch.tensor(bg),
                                        pixel_chunk=chunk)
        np.testing.assert_allclose(np_(img), np.asarray(jimg), rtol=0, atol=1e-5)
        np.testing.assert_allclose(np_(trans), np.asarray(jtrans), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_render_matches_port_oracle(seed):
    jm, jcam, jproj = _scene(seed=seed, width=64, height=64)
    bg = torch.tensor([0.1, 0.2, 0.3])
    img_o, trans_o = render_oracle(port_projected(jproj), 64, 64, CFG, bg)
    with torch.no_grad():
        out = render(port_model(jm), port_camera(jcam), CFG, sh_degree=1,
                     background=bg)
    np.testing.assert_allclose(np_(out.image), np_(img_o), atol=5e-3)
    assert float((out.image - img_o).abs().mean()) < 3e-4
    np.testing.assert_allclose(np_(out.transmittance), np_(trans_o), atol=5e-3)


def test_synthetic_views_match_jax():
    """The reference's synthetic scene from a JAX key; the port builds its
    views from the same GT model (carried over as numpy)."""
    jscene, jgt = j_datasets.synthetic_scene(
        jax.random.PRNGKey(0), n_gaussians=96, n_train=2, n_test=1, width=64,
        height=64, fx=80.0, cfg=JCFG)
    gt = port_model(jgt)
    for views, jviews, offset in ((2, jscene.train_views, 0.0),
                                  (1, jscene.test_views, 0.37)):
        got = datasets._orbit_views(gt, views, offset, 64, 64, 80.0, 6.0, CFG, 1)
        for (cam, img), (jcam, jimg) in zip(got, jviews):
            _assert_cameras_equal(cam, jcam)
            np.testing.assert_allclose(np_(img), np.asarray(jimg), rtol=0,
                                       atol=1e-5)
    scene, gt2 = datasets.synthetic_scene(
        torch.Generator().manual_seed(0), n_gaussians=32, n_train=2, n_test=1,
        width=32, height=32, fx=40.0, device="cpu")
    assert scene.init_model.capacity == 128 and int(gt2.num_alive) == 32
    assert len(scene.train_views) == 2 and len(scene.test_views) == 1
    assert scene.train_views[0][1].shape == (32, 32, 3)


def test_from_points_matches_jax():
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    cols = rng.random((300, 3)).astype(np.float32)
    for cap, deg in ((None, 3), (512, 1)):
        jm = j_from_points(pts, cols, capacity=cap, sh_degree=deg)
        tm = from_points(pts, cols, capacity=cap, sh_degree=deg, device="cpu")
        assert tm.capacity == jm.capacity and tm.sh_degree == deg
        _assert_models_equal(tm, jm)


def test_gt_model_and_cameras_match_jax():
    for deg, mask in ((3, None), (1, benchmark.SHINY_OBJECTS)):
        jm = j_benchmark.make_gt_model(2_000, sh_degree=deg, seed=0,
                                       mask_objects=mask)
        tm = benchmark.make_gt_model(2_000, sh_degree=deg, seed=0,
                                     mask_objects=mask, device="cpu")
        _assert_models_equal(tm, jm, atol=1e-6)
    for tc, jc in zip(benchmark.hemisphere_cameras(3, 48, 48, offset=0.41,
                                                   device="cpu"),
                      j_benchmark.hemisphere_cameras(3, 48, 48, offset=0.41)):
        _assert_cameras_equal(tc, jc)


def test_benchmark_scene_matches_jax():
    kw = dict(n_points=2_000, n_train=3, n_test=1, width=48, height=48,
              init_points=500, capacity=2_048, sh_degree=3)
    jscene, jgt = j_benchmark.benchmark_scene(**kw, cfg=JCFG, impl="xla")
    scene, gt = benchmark.benchmark_scene(**kw, cfg=CFG, device="cpu")
    _assert_models_equal(gt, jgt, atol=1e-6)
    _assert_models_equal(scene.init_model, jscene.init_model)
    assert scene.name == jscene.name
    for views, jviews in ((scene.train_views, jscene.train_views),
                          (scene.test_views, jscene.test_views)):
        assert len(views) == len(jviews)
        for (cam, img), (jcam, jimg) in zip(views, jviews):
            _assert_cameras_equal(cam, jcam)
            np.testing.assert_allclose(np_(img), np.asarray(jimg), rtol=0,
                                       atol=1e-5)
    # the GT cache path takes the images as they are
    cached, _ = benchmark.benchmark_scene(
        **kw, cfg=CFG, device="cpu",
        gt_images=([np_(im) for _, im in scene.train_views],
                   [np_(im) for _, im in scene.test_views]))
    assert torch.equal(cached.test_views[0][1], scene.test_views[0][1])


def _write_nerf(root, n_frames=2, size=16, fovx=np.pi / 2):
    """The fixture of tests/test_data.py TestNerfSynthetic."""
    from PIL import Image

    os.makedirs(root / "train", exist_ok=True)
    frames = []
    for i in range(n_frames):
        c2w = np.eye(4, dtype=np.float32)
        c2w[2, 3] = 4.0 + i
        rgba = np.zeros((size, size, 4), np.uint8)
        rgba[:, : size // 2] = [200, 100, 50, 255]
        rgba[:, size // 2:] = [255, 255, 255, 0]
        Image.fromarray(rgba).save(root / "train" / f"r_{i}.png")
        frames.append({"file_path": f"train/r_{i}",
                       "transform_matrix": c2w.tolist()})
    with open(root / "transforms_train.json", "w") as f:
        json.dump({"camera_angle_x": float(fovx), "frames": frames}, f)


def test_nerf_synthetic_matches_jax(tmp_path):
    _write_nerf(tmp_path)
    for white in (False, True):
        views = datasets.load_nerf_synthetic(str(tmp_path), "train",
                                             white_background=white,
                                             device="cpu")
        jviews = j_datasets.load_nerf_synthetic(str(tmp_path), "train",
                                                white_background=white)
        assert len(views) == len(jviews) == 2
        for (cam, img), (jcam, jimg) in zip(views, jviews):
            _assert_cameras_equal(cam, jcam)
            np.testing.assert_array_equal(np_(img), np.asarray(jimg))
    scene = datasets.nerf_synthetic_scene(str(tmp_path), n_init=64,
                                          capacity=128, device="cpu")
    jscene = j_datasets.nerf_synthetic_scene(str(tmp_path), n_init=64,
                                             capacity=128)
    assert len(scene.test_views) == 2   # no transforms_test.json: train[:2]
    _assert_models_equal(scene.init_model, jscene.init_model)


def _write_colmap(sparse, images=None):
    """The fixture of tests/test_data.py TestColmap, with 8 points (the
    3-nearest-neighbour init needs at least 4) and an image file."""
    os.makedirs(sparse)
    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, 640, 480))
        f.write(struct.pack("<4d", 500.0, 510.0, 320.0, 240.0))
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<idddddddi", 1, 1.0, 0, 0, 0, 0.5, 0.25, 2.0, 1))
        f.write(b"img0.png\x00")
        f.write(struct.pack("<Q", 0))
    rng = np.random.default_rng(1)
    with open(sparse / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", 8))
        for i in range(8):
            xyz = rng.normal(size=3)
            rgb = [int(v) for v in rng.integers(0, 256, 3)]
            f.write(struct.pack("<QdddBBBd", i, *xyz, *rgb, 0.1))
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<ii", 1, 0))
    if images is not None:
        from PIL import Image

        os.makedirs(images)
        px = np.random.default_rng(0).integers(0, 256, (480, 640, 3), np.uint8)
        Image.fromarray(px).save(images / "img0.png")


def test_colmap_matches_jax(tmp_path):
    from gaussiansplat_tpu.data import colmap as j_colmap

    root = tmp_path / "scene"
    _write_colmap(root / "sparse" / "0", root / "images")
    cams, xyz, rgb = read_colmap_model(str(root / "sparse" / "0"), device="cpu")
    saved = j_colmap._COLMAP_NATIVE
    j_colmap._COLMAP_NATIVE = False   # the reference's numpy readers
    try:
        jcams, jxyz, jrgb = j_read_colmap_model(str(root / "sparse" / "0"))
        jscene = j_datasets.colmap_scene(str(root), downscale=2, test_every=2)
    finally:
        j_colmap._COLMAP_NATIVE = saved
    assert [n for n, _ in cams] == [n for n, _ in jcams] == ["img0.png"]
    _assert_cameras_equal(cams[0][1], jcams[0][1])
    np.testing.assert_array_equal(xyz, jxyz)
    np.testing.assert_array_equal(rgb, jrgb)
    scene = datasets.colmap_scene(str(root), downscale=2, test_every=2,
                                  device="cpu")
    (cam, img), = scene.test_views
    (jcam, jimg), = jscene.test_views
    _assert_cameras_equal(cam, jcam)
    assert img.shape == (240, 320, 3)
    np.testing.assert_array_equal(np_(img), np.asarray(jimg))
    _assert_models_equal(scene.init_model, jscene.init_model)


def test_write_png_bytes_match_jax(tmp_path):
    img = np.random.default_rng(0).random((16, 24, 3)).astype(np.float32)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    image.write_png(a, torch.tensor(img))
    j_image.write_png(b, img)
    assert open(a, "rb").read() == open(b, "rb").read()
    sbs = image.side_by_side(torch.tensor(img), img)
    np.testing.assert_array_equal(sbs, j_image.side_by_side(img, img))


def test_scene_entry_points_default_to_cuda():
    import inspect

    from gaussiansplat_tpu_torch.data import colmap
    from gaussiansplat_tpu_torch.utils.checkpoint import import_ply

    for fn in (from_points, datasets.synthetic_scene,
               datasets.load_nerf_synthetic, datasets.nerf_synthetic_scene,
               datasets.colmap_scene, colmap.read_colmap_model,
               benchmark.make_gt_model, benchmark.hemisphere_cameras,
               benchmark.benchmark_scene, import_ply):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
