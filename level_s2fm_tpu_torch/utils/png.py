"""PNG reader and writer on zlib and numpy.

The port reads the prepared scenes' PNGs (8-bit RGB images, 16-bit depth
maps) without an image library: ``read_png`` parses the chunks, inflates
the IDAT stream with zlib and undoes the per-row filters in C++
(``cpp/native/pngfilter.cpp``, built with g++ at first use like
minigeom; the build raises if it fails). Supported: bit depths 8 and 16;
gray, gray + alpha, RGB and RGBA; no interlace. The array comes back as
imageio gives it: uint8 or uint16, [H,W] for gray, [H,W,C] otherwise.
``write_png`` writes the same kinds with filter type 0.
"""
from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
#: PNG color type -> channels
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}
_LIB = None
_LOCK = threading.Lock()
_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "cpp", "native", "pngfilter.cpp")


def build() -> str:
    """Build the unfilter library if it is missing; return its path."""
    from ..cpp.minigeom import build_shared
    return build_shared(_SOURCE, "pngfilter")


def _load():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            u8 = ctypes.POINTER(ctypes.c_uint8)
            lib.png_unfilter.restype = ctypes.c_int
            lib.png_unfilter.argtypes = [u8, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, u8]
            _LIB = lib
        return _LIB


def unfilter(raw: bytes, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Undo the scanline filters of ``height`` rows of ``rowbytes`` bytes
    (each preceded by its filter byte). Returns [height * rowbytes] uint8."""
    need = height * (rowbytes + 1)
    if len(raw) < need:
        raise ValueError(f"PNG data too short: {len(raw)} < {need} bytes")
    src = np.frombuffer(raw, np.uint8, count=need)
    out = np.empty(height * rowbytes, np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    bad = _load().png_unfilter(src.ctypes.data_as(u8), height, rowbytes, bpp,
                               out.ctypes.data_as(u8))
    if bad:
        raise ValueError(f"PNG row {bad - 1}: unknown filter type")
    return out


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, color, _, _, interlace = hdr
    if color not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"{path}: unsupported PNG (color type {color}, "
                         f"bit depth {depth}); supported: gray, gray+alpha, "
                         "RGB, RGBA at 8 or 16 bits")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    out = unfilter(zlib.decompress(b"".join(idat)), H, W * bpp, bpp)
    if depth == 16:
        out = out.view(">u2").astype(np.uint16)
    out = out.reshape(H, W, ch)
    return out[..., 0] if ch == 1 else out


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write uint8 or uint16 [H,W] / [H,W,C] (C in 1..4) as a PNG."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"write_png takes uint8 or uint16, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    H, W, ch = img.shape
    if ch not in _COLOR_TYPE:
        raise ValueError(f"write_png: {ch} channels")
    depth = 16 if img.dtype == np.uint16 else 8
    rows = img.astype(">u2" if depth == 16 else np.uint8).reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8),
                          rows.view(np.uint8).reshape(H, -1)], axis=1)
    hdr = struct.pack(">IIBBBBB", W, H, depth, _COLOR_TYPE[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIG + _chunk(b"IHDR", hdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
                + _chunk(b"IEND", b""))
