"""INRIA-format 3DGS PLY reader/writer (numpy only, no plyfile dependency).

Field names match the ecosystem: `x,y,z, nx,ny,nz, f_dc_0..2, f_rest_0..44,
opacity, scale_0..2, rot_0..3`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

_DTYPES = {
    "char": np.int8, "uchar": np.uint8,
    "short": np.int16, "ushort": np.uint16,
    "int": np.int32, "uint": np.uint32,
    "int8": np.int8, "uint8": np.uint8,
    "int16": np.int16, "uint16": np.uint16,
    "int32": np.int32, "uint32": np.uint32,
    "float": np.float32, "float32": np.float32,
    "double": np.float64, "float64": np.float64,
}
_DTYPE_NAMES = {np.dtype(np.float32): "float", np.dtype(np.float64): "double",
                np.dtype(np.uint8): "uchar", np.dtype(np.int32): "int"}


@dataclass
class PlyElement:
    name: str
    count: int
    properties: List[Tuple[str, np.dtype]]


def _parse_header(f) -> Tuple[List[PlyElement], str]:
    if f.readline().strip() != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements: List[PlyElement] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens or tokens[0] == "comment":
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            elements.append(PlyElement(tokens[1], int(tokens[2]), []))
        elif tokens[0] == "property":
            if tokens[1] == "list":
                raise ValueError("list properties not supported (not used by 3DGS)")
            elements[-1].properties.append((tokens[2], np.dtype(_DTYPES[tokens[1]])))
        elif tokens[0] == "end_header":
            break
    if fmt not in ("binary_little_endian", "ascii"):
        raise ValueError(f"unsupported PLY format {fmt}")
    return elements, fmt


def read_ply(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Read a PLY into {element: {property: (count,) array}}."""
    with open(path, "rb") as f:
        elements, fmt = _parse_header(f)
        out: Dict[str, Dict[str, np.ndarray]] = {}
        for el in elements:
            dtype = np.dtype([(n, d) for n, d in el.properties])
            if fmt == "binary_little_endian":
                raw = f.read(dtype.itemsize * el.count)
                arr = np.frombuffer(raw, dtype=dtype, count=el.count)
            else:
                rows = [f.readline().split() for _ in range(el.count)]
                arr = np.array(
                    [tuple(t) for t in rows],
                    dtype=np.dtype([(n, np.float64) for n, _ in el.properties]),
                ).astype(dtype)
            out[el.name] = {n: np.ascontiguousarray(arr[n]) for n, _ in el.properties}
        return out


def write_ply(path: str, vertex: Dict[str, np.ndarray]) -> None:
    """Write a binary_little_endian PLY with a single `vertex` element."""
    names = list(vertex.keys())
    count = len(next(iter(vertex.values())))
    dtype = np.dtype([(n, np.asarray(vertex[n]).dtype) for n in names])
    arr = np.empty(count, dtype=dtype)
    for n in names:
        v = np.asarray(vertex[n])
        if v.shape != (count,):
            raise ValueError(f"{n}: shape {v.shape}, expected ({count},)")
        arr[n] = v
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {count}\n".encode())
        for n in names:
            f.write(f"property {_DTYPE_NAMES[np.dtype(arr[n].dtype)]} {n}\n".encode())
        f.write(b"end_header\n")
        f.write(arr.tobytes())


def sh_rest_count(vertex: Dict[str, np.ndarray]) -> int:
    n = 0
    while f"f_rest_{n}" in vertex:
        n += 1
    return n


def load_gaussian_ply(path: str):
    """Parse an INRIA 3DGS PLY into float32 arrays (means, quats, log_scales,
    logit_opacities, sh_dc (N, 1, 3), sh_rest (N, K-1, 3)). `f_rest` is
    stored channel-major in the file ((3, K-1) flattened)."""
    vertex = read_ply(path)["vertex"]
    n = len(vertex["x"])
    means = np.stack([vertex["x"], vertex["y"], vertex["z"]], -1).astype(np.float32)
    quats = np.stack([vertex[f"rot_{i}"] for i in range(4)], -1).astype(np.float32)
    log_scales = np.stack(
        [vertex[f"scale_{i}"] for i in range(3)], -1).astype(np.float32)
    logit_op = vertex["opacity"].astype(np.float32)
    sh_dc = np.stack(
        [vertex[f"f_dc_{i}"] for i in range(3)], -1).astype(np.float32)[:, None, :]
    m = sh_rest_count(vertex)
    if m:
        rest = np.stack([vertex[f"f_rest_{i}"] for i in range(m)], -1)
        rest = rest.reshape(n, 3, m // 3).transpose(0, 2, 1)  # (N, K-1, 3)
    else:
        rest = np.zeros((n, 0, 3), np.float32)
    return means, quats, log_scales, logit_op, sh_dc, rest.astype(np.float32)


def save_gaussian_ply(path, means, quats, log_scales, logit_opacities, sh_dc,
                      sh_rest) -> None:
    """Write model arrays as an ecosystem-compatible 3DGS PLY. SH arrays may
    be band-major (N, K, 3) or flat (N, 3K)."""
    n = means.shape[0]
    f32 = lambda a: np.ascontiguousarray(np.asarray(a, np.float32))
    vertex: Dict[str, np.ndarray] = {}
    for i, k in enumerate("xyz"):
        vertex[k] = f32(means[:, i])
    for k in ("nx", "ny", "nz"):
        vertex[k] = np.zeros(n, np.float32)
    dc = np.asarray(sh_dc, np.float32).reshape(n, 3)
    for i in range(3):
        vertex[f"f_dc_{i}"] = f32(dc[:, i])
    rest = np.asarray(sh_rest).reshape(n, -1, 3)  # band-major -> channel-major
    m = rest.shape[1] * 3
    rest_cm = rest.transpose(0, 2, 1).reshape(n, m)
    for i in range(m):
        vertex[f"f_rest_{i}"] = f32(rest_cm[:, i])
    vertex["opacity"] = f32(logit_opacities)
    for i in range(3):
        vertex[f"scale_{i}"] = f32(log_scales[:, i])
    for i in range(4):
        vertex[f"rot_{i}"] = f32(quats[:, i])
    write_ply(path, vertex)
