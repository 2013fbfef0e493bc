"""Minimal dependency-free PNG writer/reader, 8-bit gray/RGB/RGBA (the
port's copy of ``owlexabrick_tpu/utils/png.py``: the same chunks, zlib
level 6 and filter 0, so both packages write the same bytes), and the
golden-image gate."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def write_png(path, image: np.ndarray) -> None:
    """image: (H, W), (H, W, 3) or (H, W, 4) uint8 (row 0 = top).
    ``path`` may be a filesystem path or a binary file-like object."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError("write_png expects uint8")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + img[row].tobytes() for row in range(h))
    out = b"\x89PNG\r\n\x1a\n"
    out += _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0,
                                       0, 0))
    out += _chunk(b"IDAT", zlib.compress(raw, 6))
    out += _chunk(b"IEND", b"")
    if hasattr(path, "write"):
        path.write(out)
    else:
        with open(path, "wb") as f:
            f.write(out)


def read_png(path) -> np.ndarray:
    """Reads 8-bit non-interlaced gray/RGB/RGBA PNGs (filters 0-4) from a
    path or a file-like object."""
    if hasattr(path, "read"):
        data = path.read()
    else:
        with open(path, "rb") as f:
            data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a png")
    pos = 8
    idat = b""
    w = h = channels = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, color, _, _, inter = struct.unpack(">IIBBBBB", body)
            if depth != 8 or inter != 0:
                raise ValueError("unsupported png (need 8-bit "
                                 "non-interlaced)")
            channels = {0: 1, 2: 3, 6: 4, 4: 2}[color]
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    raw = zlib.decompress(idat)
    stride = w * channels
    img = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for row in range(h):
        f = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int32)
        pos += 1 + stride
        cur = np.zeros(stride, np.int32)
        if f == 0:
            cur = line
        elif f == 2:  # up
            cur = (line + prev) & 0xFF
        else:
            for i in range(stride):
                a = cur[i - channels] if i >= channels else 0
                b = prev[i]
                cc = prev[i - channels] if i >= channels else 0
                if f == 1:
                    pred = a
                elif f == 3:
                    pred = (a + b) // 2
                elif f == 4:
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = (a if (pa <= pb and pa <= pc)
                            else (b if pb <= pc else cc))
                else:
                    raise ValueError(f"bad filter {f}")
                cur[i] = (line[i] + pred) & 0xFF
        img[row] = cur.astype(np.uint8)
        prev = cur
    return img.reshape(h, w, channels)


def golden_gate(img: np.ndarray, want: np.ndarray):
    """The JAX package's golden-image gate
    (``tests/test_golden_images.py::_check``): every pixel within 1/255
    per channel and at least 99% of pixels bit-exact.  Returns
    (passed, max_abs_diff, exact_fraction)."""
    if want.shape != img.shape:
        return False, None, 0.0
    d = np.abs(img.astype(int) - want.astype(int))
    exact = float((d == 0).all(-1).mean())
    return bool(d.max() <= 1 and exact >= 0.99), int(d.max()), exact
