"""Dependency-free PNG writer for training previews.

Pure stdlib (zlib + struct), 8-bit RGB, so the trainer needs no imaging
library. Images may be numpy arrays or tensors on any device.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch


def _host(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def to_uint8(img) -> np.ndarray:
    """Clamp a float (H, W, 3) image in [0, 1] to uint8."""
    a = np.asarray(_host(img), dtype=np.float32)
    return (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img) -> None:
    """Write an (H, W, 3) image (float in [0, 1] or uint8) as an RGB PNG."""
    a = _host(img)
    if a.dtype != np.uint8:
        a = to_uint8(a)
    if a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3), got {a.shape}")
    h, w = a.shape[:2]

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    # Filter byte 0 (None) per scanline.
    raw = b"".join(b"\x00" + a[y].tobytes() for y in range(h))
    data = zlib.compress(raw, 6)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", data))
        f.write(chunk(b"IEND", b""))


def side_by_side(pred, gt) -> np.ndarray:
    """Horizontal [prediction | ground truth] preview."""
    return np.concatenate([to_uint8(pred), to_uint8(gt)], axis=1)
