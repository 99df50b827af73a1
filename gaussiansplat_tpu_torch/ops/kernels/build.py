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
from typing import Iterable, List, Optional, Sequence

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
        self._lib = None
        self._fns = {}
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

    def fn(self, symbol: Optional[str] = None,
           argtypes: Optional[Sequence] = None):
        """The bound C launcher `symbol` (default: the kernel's own), building
        the library at first use. A source may export several launchers
        with the same arguments (one per instantiation of a template);
        another function of the library gives its own `argtypes`."""
        symbol = symbol or self.symbol
        if symbol not in self._fns:
            if self._lib is None:
                self.build()
                lib = ctypes.CDLL(str(self.library_path()))
                err = lib.gs_error_string
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._lib, self._err = lib, err
            f = getattr(self._lib, symbol)
            f.argtypes = self.argtypes if argtypes is None else list(argtypes)
            f.restype = ctypes.c_int
            self._fns[symbol] = f
        return self._fns[symbol]

    def launch(self, *args, symbol: Optional[str] = None) -> None:
        """Call the launcher; raise if the launch was refused."""
        rc = self.fn(symbol)(*args)
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


def ptxas_usage(log: str) -> dict:
    """Registers a thread, static shared memory and spill bytes of the
    (one) kernel of an `-Xptxas -v` log."""
    import re

    def grab(pattern):
        m = re.search(pattern, log)
        return int(m.group(1)) if m else 0

    return dict(registers=grab(r"Used (\d+) registers"),
                smem=grab(r"(\d+) bytes smem"),
                spill_stores=grab(r"(\d+) bytes spill stores"),
                spill_loads=grab(r"(\d+) bytes spill loads"))


# Per-SM limits of compute capability 9.0 (CUDA C++ programming guide,
# "Technical Specifications per Compute Capability"; the occupancy
# calculator's allocation units).
_SM90 = dict(threads=2048, blocks=32, registers=65536, reg_unit=256,
            smem=233472, smem_reserved=1024, smem_unit=128)


def blocks_per_sm(registers: int, threads: int, smem_bytes: int) -> int:
    """Blocks of `threads` threads that fit on one SM of compute capability
    9.0 at `registers` a thread and `smem_bytes` of shared memory a block
    (static plus dynamic)."""
    lim = _SM90
    warps = -(-threads // 32)
    per_warp = -(-registers * 32 // lim["reg_unit"]) * lim["reg_unit"]
    by_regs = (lim["registers"] // per_warp) // warps if per_warp else lim["blocks"]
    smem = -(-smem_bytes // lim["smem_unit"]) * lim["smem_unit"] + lim["smem_reserved"]
    return min(lim["blocks"], lim["threads"] // threads, by_regs,
               lim["smem"] // smem)


def sass_counts(path) -> dict:
    """Instructions of a built library's SASS by opcode (`cuobjdump -sass`,
    the toolkit's disassembler): 'total', each opcode without its modifiers
    (e.g. 'MUFU'), each MUFU function ('MUFU.EX2') and 'LDG.128' (16-byte
    global loads)."""
    import re
    from collections import Counter

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts: Counter = Counter()
    for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)",
                         text):
        op = m.group(1)
        counts["total"] += 1
        counts[op.split(".")[0]] += 1
        if op.startswith("MUFU."):
            counts[".".join(op.split(".")[:2])] += 1
        if op.startswith("LDG") and ".128" in op:
            counts["LDG.128"] += 1
    return dict(counts)
