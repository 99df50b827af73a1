"""ctypes loaders for the native (C++) PLY and COLMAP parsers.

The sources are the repo's `native/ply_io.cpp` and `native/colmap_io.cpp`.
They are compiled with `g++` at first use into the port's own
`gaussiansplat_tpu_torch/_build/` (listed in .gitignore), under a file name
that carries a hash of the source and the flags, so an edited source is
never served a stale build; `native/build/` is only read, never written.
Every native reader has a numpy fallback (`data/ply.py`, `data/colmap.py`),
used when no compiler is found or the build fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..ops.kernels.build import BUILD_DIR

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
_LOCK = threading.Lock()


def library_path(name: str, source: str) -> Path:
    """Where the build of native/<source> goes: _build/lib<name>-<hash>.so."""
    h = hashlib.sha256((NATIVE_DIR / source).read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_lib(name: str, source: str) -> Optional[Path]:
    """Compile native/<source> into _build/ unless that build exists; None
    when the source or g++ is missing or the compile fails."""
    src = NATIVE_DIR / source
    gxx = shutil.which("g++")
    if not src.exists():
        return None
    out = library_path(name, source)
    with _LOCK:
        if out.exists():
            return out
        if gxx is None:
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(src)],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, out)
    return out


class PlyNative:
    """Wrapper over native/ply_io.cpp."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.ply_open.restype = ctypes.c_void_p
        lib.ply_open.argtypes = [ctypes.c_char_p]
        lib.ply_vertex_count.restype = ctypes.c_int64
        lib.ply_vertex_count.argtypes = [ctypes.c_void_p]
        lib.ply_field_count.restype = ctypes.c_int32
        lib.ply_field_count.argtypes = [ctypes.c_void_p]
        lib.ply_field_name.restype = ctypes.c_char_p
        lib.ply_field_name.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.ply_read_columns_f32.restype = None
        lib.ply_read_columns_f32.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int32]
        lib.ply_close.restype = None
        lib.ply_close.argtypes = [ctypes.c_void_p]

    def parse_vertex_element(self, path: str) -> Dict[str, np.ndarray]:
        """The `vertex` element of a binary little-endian PLY, every
        property as a float32 column."""
        h = self._lib.ply_open(os.fsencode(path))
        if not h:
            raise IOError(f"native PLY parser could not open {path}")
        try:
            n = self._lib.ply_vertex_count(h)
            nf = self._lib.ply_field_count(h)
            names = [self._lib.ply_field_name(h, i).decode() for i in range(nf)]
            out = np.empty((nf, n), np.float32)
            self._lib.ply_read_columns_f32(
                h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 0)
            return {name: out[i] for i, name in enumerate(names)}
        finally:
            self._lib.ply_close(h)


def load_ply_native() -> Optional[PlyNative]:
    so = build_lib("ply_io", "ply_io.cpp")
    if so is None:
        return None
    try:
        return PlyNative(ctypes.CDLL(str(so)))
    except OSError:
        return None


class ColmapNative:
    """Wrapper over native/colmap_io.cpp (points3D.bin / images.bin)."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        for fn in ("colmap_points_count", "colmap_images_count"):
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_char_p]
        lib.colmap_read_points3d.restype = ctypes.c_int64
        lib.colmap_read_points3d.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float)]
        lib.colmap_read_images.restype = ctypes.c_int64
        lib.colmap_read_images.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p]

    def read_points3d(self, path: str):
        p = os.fsencode(path)
        n = self._lib.colmap_points_count(p)
        if n < 0:
            raise IOError(f"native COLMAP parser could not open {path}")
        xyz = np.empty((n, 3), np.float32)
        rgb = np.empty((n, 3), np.float32)
        got = self._lib.colmap_read_points3d(
            p, xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if got != n:
            raise IOError(f"truncated points3D.bin: {got}/{n} records")
        return xyz, rgb

    def read_images(self, path: str):
        p = os.fsencode(path)
        n = self._lib.colmap_images_count(p)
        if n < 0:
            raise IOError(f"native COLMAP parser could not open {path}")
        quat = np.empty((n, 4), np.float64)
        t = np.empty((n, 3), np.float64)
        cam_id = np.empty((n,), np.int32)
        names = ctypes.create_string_buffer(n * 256)
        got = self._lib.colmap_read_images(
            p, quat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            t.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            cam_id.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), names)
        if got != n:
            raise IOError(f"truncated images.bin: {got}/{n} records")
        return [dict(quat=quat[i], t=t[i], camera_id=int(cam_id[i]),
                     name=names.raw[i * 256:(i + 1) * 256].split(b"\x00", 1)[0]
                     .decode())
                for i in range(n)]


def load_colmap_native() -> Optional[ColmapNative]:
    so = build_lib("colmap_io", "colmap_io.cpp")
    if so is None:
        return None
    try:
        return ColmapNative(ctypes.CDLL(str(so)))
    except OSError:
        return None
