"""PNG read/write with the standard library's zlib and numpy.

The machine with the card has no imageio, PIL or cv2, so the port carries
its own codec: grayscale, gray+alpha, RGB and RGBA, filter types 0-4, no
interlace; it writes 8-bit and reads 8-bit and 16-bit (as uint16). ``encode_png``/``decode_png`` work on bytes in memory (the
viewer's frames: the only codec it uses, on any machine), ``write_png``/
``read_png`` on files. ``read_image``/``write_image`` use imageio when it is
importable and this codec otherwise.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # PNG colour type -> channels
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)


def encode_png(arr: np.ndarray) -> bytes:
    """uint8 [H, W] or [H, W, 1|2|3|4] -> PNG bytes (filter type 0 on every
    row, zlib level 6: the same input gives the same bytes)."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError(f"encode_png needs uint8, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    H, W, C = arr.shape
    if C not in _COLOR_TYPE:
        raise ValueError(f"encode_png needs 1-4 channels, got {C}")
    raw = np.concatenate([np.zeros((H, 1), np.uint8), arr.reshape(H, W * C)], axis=1)
    header = struct.pack(">IIBBBBB", W, H, 8, _COLOR_TYPE[C], 0, 0, 0)
    return b"".join((_SIGNATURE, _chunk(b"IHDR", header), _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)),
                     _chunk(b"IEND", b"")))


def write_png(path: str, arr: np.ndarray) -> None:
    """Write uint8 [H, W] or [H, W, 1|2|3|4] as a PNG (``encode_png``)."""
    blob = encode_png(arr)
    with open(path, "wb") as f:
        f.write(blob)


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(data: np.ndarray, H: int, W: int, C: int) -> np.ndarray:
    stride = W * C
    rows = data.reshape(H, stride + 1)
    out = np.zeros((H, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(H):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: running sum along the row, per channel
            cur = np.cumsum(line.reshape(W, C), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            cur = np.zeros(stride, np.int32)
            left = np.zeros(C, np.int32)
            up_left = np.zeros(C, np.int32)
            for x in range(W):
                sl = slice(x * C, (x + 1) * C)
                up = prev[sl]
                pred = (left + up) // 2 if ftype == 3 else _paeth(left, up, up_left)
                left = (line[sl] + pred) & 0xFF
                cur[sl] = left
                up_left = up
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out.astype(np.uint8).reshape(H, W, C)


def decode_png(blob: bytes, name: str = "PNG data") -> np.ndarray:
    """8- or 16-bit, non-interlaced PNG bytes -> uint8 or uint16 [H, W, C] (C = 1..4)."""
    if not blob.startswith(_SIGNATURE):
        raise ValueError(f"{name}: not a PNG file")
    pos, idat, header = len(_SIGNATURE), [], None
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos : pos + 4])
        tag = blob[pos + 4 : pos + 8]
        data = blob[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    W, H, depth, color_type, _, _, interlace = header
    if depth not in (8, 16) or color_type not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{name}: only 8- or 16-bit non-interlaced gray/RGB(A) PNGs are supported "
            f"(depth {depth}, colour type {color_type}, interlace {interlace})"
        )
    data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    C = _CHANNELS[color_type]
    if depth == 8:
        return _unfilter(data, H, W, C)
    raw = _unfilter(data, H, W, 2 * C).reshape(H, W, C, 2).astype(np.uint16)  # filters work on bytes
    return (raw[..., 0] << 8) | raw[..., 1]  # big-endian samples


def read_png(path: str) -> np.ndarray:
    """Read a non-interlaced PNG file -> uint8 (uint16 for 16-bit) [H, W, C] (C = 1..4)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def read_image(path: str) -> np.ndarray:
    """Image array (uint8, uint16 for a 16-bit PNG), through imageio when
    importable, else ``read_png``."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        img = read_png(path)
        return img[..., 0] if img.shape[-1] == 1 else img
    return imageio.imread(path)


def write_image(path: str, arr: np.ndarray) -> None:
    """Write a uint8 image, through imageio when importable, else ``write_png``."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        write_png(path, arr)
        return
    imageio.imwrite(path, arr)
