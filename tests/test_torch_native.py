"""The port's native PLY and COLMAP parsers (data/native_loader.py, built
with g++ from native/*.cpp into gaussiansplat_tpu_torch/_build/) against
its numpy readers and the reference's loaders, on files written here.
Values must be exactly equal."""

import os
import struct
from pathlib import Path

import numpy as np

from gaussiansplat_tpu.data import colmap as jcolmap
from gaussiansplat_tpu.data import ply as jply
from gaussiansplat_tpu_torch.data import colmap as tcolmap
from gaussiansplat_tpu_torch.data import native_loader
from gaussiansplat_tpu_torch.data import ply as tply
from gaussiansplat_tpu_torch.ops.kernels.build import BUILD_DIR

from test_torch_common import limit_torch_threads

limit_torch_threads()

NATIVE_BUILD = Path(native_loader.NATIVE_DIR) / "build"


def _mtimes():
    return {p.name: p.stat().st_mtime_ns for p in NATIVE_BUILD.glob("*")}


def _arrays(n=1000, k_rest=15, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        means=rng.normal(size=(n, 3)).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        log_scales=rng.normal(size=(n, 3)).astype(np.float32),
        logit_opacities=rng.normal(size=(n,)).astype(np.float32),
        sh_dc=rng.normal(size=(n, 1, 3)).astype(np.float32),
        sh_rest=rng.normal(size=(n, k_rest, 3)).astype(np.float32),
    )


def test_ply_native_matches_numpy_and_reference(tmp_path, monkeypatch):
    before = _mtimes()
    lib = native_loader.load_ply_native()
    assert lib is not None, "g++ builds native/ply_io.cpp"
    so = native_loader.library_path("ply_io", "ply_io.cpp")
    assert so.exists() and so.parent == BUILD_DIR
    assert _mtimes() == before, "native/build/ must not change"

    path = str(tmp_path / "model.ply")
    tply.save_gaussian_ply(path, **_arrays())
    ref = tply.read_ply(path)["vertex"]
    nat = lib.parse_vertex_element(path)
    assert set(nat) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(nat[k], ref[k].astype(np.float32))

    got = tply.load_gaussian_ply(path)
    assert tply.LAST_PARSER == "native"
    monkeypatch.setattr(tply, "_NATIVE", False)
    plain = tply.load_gaussian_ply(path)
    assert tply.LAST_PARSER == "numpy"
    assert _mtimes() == before
    # The reference's reader (its numpy path: its own native loader may
    # rebuild into native/build/).
    monkeypatch.setattr(jply, "_NATIVE", False)
    want = jply.load_gaussian_ply(path)
    for a, b, c in zip(got, plain, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, np.asarray(c))


def test_ply_ascii_falls_back_to_numpy(tmp_path):
    path = str(tmp_path / "a.ply")
    names = ["x", "y", "z", "opacity"] + [f"{p}_{i}" for p, m in
                                         (("f_dc", 3), ("scale", 3), ("rot", 4))
                                         for i in range(m)]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 2\n")
        f.writelines(f"property float {n}\n" for n in names)
        f.write("end_header\n")
        f.write(" ".join(["1.5"] * len(names)) + "\n")
        f.write(" ".join(["-2.0"] * len(names)) + "\n")
    means = tply.load_gaussian_ply(path)[0]
    assert tply.LAST_PARSER == "numpy"
    np.testing.assert_array_equal(means, [[1.5] * 3, [-2.0] * 3])


def _write_colmap(sparse, n_pts=257, n_imgs=9):
    rng = np.random.default_rng(0)
    os.makedirs(sparse, exist_ok=True)
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", n_imgs))
        for i in range(n_imgs):
            f.write(struct.pack("<idddddddi", i, *rng.normal(size=4),
                                *rng.normal(size=3), i % 3))
            f.write(f"frame_{i:03d}_{'x' * (i % 40)}.png".encode() + b"\x00")
            n2d = int(rng.integers(0, 50))
            f.write(struct.pack("<Q", n2d))
            f.write(b"\x00" * (24 * n2d))
    with open(sparse / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", n_pts))
        for i in range(n_pts):
            rgb = [int(v) for v in rng.integers(0, 256, size=3)]
            f.write(struct.pack("<QdddBBBd", i, *rng.normal(size=3), *rgb, 0.5))
            tl = int(rng.integers(0, 12))
            f.write(struct.pack("<Q", tl))
            f.write(b"\x00" * (8 * tl))


def test_colmap_native_matches_numpy_and_reference(tmp_path, monkeypatch):
    before = _mtimes()
    native = native_loader.load_colmap_native()
    assert native is not None, "g++ builds native/colmap_io.cpp"
    assert native_loader.library_path("colmap_io", "colmap_io.cpp").exists()
    assert _mtimes() == before, "native/build/ must not change"
    sparse = tmp_path / "sparse"
    _write_colmap(sparse)
    pts, imgs = str(sparse / "points3D.bin"), str(sparse / "images.bin")

    nx, nc = tcolmap.read_points3d_bin(pts)
    assert tcolmap.LAST_PARSER == "native"
    nimgs = tcolmap.read_images_bin(imgs)
    assert tcolmap.LAST_PARSER == "native"
    monkeypatch.setattr(tcolmap, "_COLMAP_NATIVE", False)
    px, pc = tcolmap.read_points3d_bin(pts)
    assert tcolmap.LAST_PARSER == "numpy"
    pimgs = tcolmap.read_images_bin(imgs)
    assert _mtimes() == before
    monkeypatch.setattr(jcolmap, "_COLMAP_NATIVE", False)
    jx, jc = jcolmap.read_points3d_bin(pts)
    jimgs = jcolmap.read_images_bin(imgs)
    for a in (px, jx):
        np.testing.assert_array_equal(nx, a)
    for a in (pc, jc):
        np.testing.assert_array_equal(nc, a)
    assert len(nimgs) == len(pimgs) == len(jimgs) == 9
    for a, b, c in zip(nimgs, pimgs, jimgs):
        for k in ("name", "camera_id"):
            assert a[k] == b[k] == c[k]
        for k in ("quat", "t"):
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], c[k])


def test_build_is_keyed_on_the_source(tmp_path, monkeypatch):
    src = tmp_path / "native"
    src.mkdir()
    (src / "x.cpp").write_text('extern "C" int one() { return 1; }\n')
    monkeypatch.setattr(native_loader, "NATIVE_DIR", src)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    first = native_loader.build_lib("x", "x.cpp")
    assert first is not None and first.parent == tmp_path / "build"
    (src / "x.cpp").write_text('extern "C" int one() { return 2; }\n')
    second = native_loader.library_path("x", "x.cpp")
    assert second != first and not second.exists()
    assert native_loader.build_lib("x", "x.cpp") == second
    assert native_loader.build_lib("missing", "missing.cpp") is None
