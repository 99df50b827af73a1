"""Build the port's CUDA sources and bind them with ctypes.

Each `csrc/<name>.cu` exposes a plain C launcher that takes device pointers
and a stream and returns the launch's `cudaGetLastError()`. It is compiled
by `nvcc` for sm_90a into its own shared library under `_build/` (listed in
.gitignore) at first use; the library's file name carries a hash of the
source, the `*.cuh` headers beside it and the flags, so an edited source
or header is never served a stale build.
`build_all` starts one `nvcc` per source, all at once.

Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterable, List, Sequence

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


class CudaKernel:
    """One CUDA source, its C launcher and a count of launches.

    `launches` is a plain integer that the Python wrapper increments each
    time it launches the kernel (and nowhere else). `defines` are passed to
    nvcc as `-D` flags (a test build of the same source, e.g. with the
    raster kernels' support cull off)."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence,
                 defines: Sequence[str] = ()):
        self.source = CSRC_DIR / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
        self.launches = 0
        self.build_log = ""
        self._fn = None
        self._err = None

    @property
    def name(self) -> str:
        return self.source.stem

    def library_path(self) -> Path:
        # The headers beside the source are the ones nvcc includes: hash
        # those, not the checkout's, or a source built from another tree
        # with the same .cu but other headers would reuse this tree's build.
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):
            h.update(header.name.encode())
            h.update(header.read_bytes())
        h.update(" ".join(self.flags).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def _start_build(self):
        """Start nvcc into a temporary file; None if the library exists."""
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *self.flags, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        return proc, tmp

    def _finish_build(self, started) -> None:
        if started is None:
            return
        proc, tmp = started
        self.build_log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source}:\n{self.build_log}")
        os.replace(tmp, self.library_path())

    def build(self) -> None:
        self._finish_build(self._start_build())

    def fn(self):
        """The bound C launcher (building the library at first use)."""
        if self._fn is None:
            self.build()
            lib = ctypes.CDLL(str(self.library_path()))
            f = getattr(lib, self.symbol)
            f.argtypes = self.argtypes
            f.restype = ctypes.c_int
            err = lib.gs_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._err, self._fn = err, f
        return self._fn

    def launch(self, *args) -> None:
        """Call the launcher; raise if the launch was refused."""
        rc = self.fn()(*args)
        if rc != 0:
            msg = self._err(rc).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: "
                               f"CUDA error {rc} ({msg})")
        self.launches += 1


def build_all(kernels: Iterable[CudaKernel]) -> List[CudaKernel]:
    """Build every given kernel, one nvcc process per distinct library, in
    parallel. Kernels whose sources hash alike share one build and its log."""
    kernels = list(kernels)
    first = {}
    for k in kernels:
        first.setdefault(k.library_path(), k)
    procs = [(k, k._start_build()) for k in first.values()]
    for k, p in procs:
        k._finish_build(p)
    for k in kernels:
        k.build_log = k.build_log or first[k.library_path()].build_log
    return kernels


def ptxas_lines(log: str) -> List[str]:
    """The register / shared-memory / spill lines of an `-Xptxas -v` log."""
    keys = ("registers", "spill", "smem", "Compiling entry")
    return [ln.strip() for ln in log.splitlines() if any(k in ln for k in keys)]
