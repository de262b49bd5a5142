"""Animated GIF writer on numpy alone.

The GPU machine has neither imageio nor Pillow, so the port writes its
animations itself: GIF89a with one global table of at most 256 colours,
the frames' pixels as LZW codes (variable width, 9 to 12 bits, a clear
code when the table is full), a delay per frame and the NETSCAPE2.0
loop extension. ``palette_indices`` picks the table: the frames' own
colours where there are at most 256 of them, otherwise a median cut of
the colour cube, each pixel mapped to its nearest entry.
"""
from __future__ import annotations

import struct

import numpy as np


def _median_cut(colors: np.ndarray, counts: np.ndarray, n: int) -> np.ndarray:
    """Up to ``n`` palette colours [k,3] uint8: the box of distinct colours
    with the widest channel range is split at its weighted median until
    there are ``n`` boxes; each box gives its pixel-weighted mean."""
    boxes = [np.arange(len(colors))]
    while len(boxes) < n:
        spans = [np.ptp(colors[b], axis=0).max() if len(b) > 1 else -1 for b in boxes]
        i = int(np.argmax(spans))
        if spans[i] <= 0:
            break
        b = boxes.pop(i)
        ch = int(np.argmax(np.ptp(colors[b], axis=0)))
        b = b[np.argsort(colors[b, ch], kind="stable")]
        cum = np.cumsum(counts[b])
        cut = int(np.searchsorted(cum, cum[-1] / 2.0)) + 1
        cut = min(max(cut, 1), len(b) - 1)
        boxes += [b[:cut], b[cut:]]
    return np.stack([np.round(np.average(colors[b], axis=0, weights=counts[b]))
                     for b in boxes]).astype(np.uint8)


def palette_indices(frames):
    """(indices [F,H,W] uint8, palette [k,3] uint8, k <= 256) for uint8
    RGB frames [F,H,W,3]."""
    frames = np.asarray(frames, np.uint8)
    flat = frames.reshape(-1, 3)
    colors, inverse, counts = np.unique(flat, axis=0, return_inverse=True,
                                        return_counts=True)
    inverse = inverse.reshape(-1)
    if len(colors) <= 256:
        palette, lut = colors, np.arange(len(colors))
    else:
        palette = _median_cut(colors.astype(np.int64), counts, 256)
        d = ((colors[:, None, :].astype(np.int64) - palette[None].astype(np.int64)) ** 2).sum(-1)
        lut = np.argmin(d, axis=1)
    return lut[inverse].astype(np.uint8).reshape(frames.shape[:3]), palette


def lzw_codes(indices: np.ndarray, min_code_size: int = 8) -> bytes:
    """The GIF LZW stream of one frame's palette indices, packed LSB first
    (without the sub-block framing)."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    out, acc, nbits = bytearray(), 0, 0

    def emit(code, size):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    def fresh():
        return {(i,): i for i in range(clear)}, min_code_size + 1, end + 1

    table, size, next_code = fresh()
    emit(clear, size)
    data = np.asarray(indices, np.uint8).reshape(-1).tolist()
    w = (data[0],)
    for k in data[1:]:
        wk = w + (k,)
        if wk in table:
            w = wk
            continue
        emit(table[w], size)
        if next_code < 4096:
            table[wk] = next_code
            next_code += 1
            if next_code > (1 << size) and size < 12:
                size += 1
        else:
            emit(clear, size)
            table, size, next_code = fresh()
        w = (k,)
    emit(table[w], size)
    emit(end, size)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def write_gif(path: str, frames, fps: float = 4.0, loop: int = 0) -> None:
    """Write uint8 RGB frames [F,H,W,3] as an animated GIF (``loop`` 0
    repeats forever)."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"write_gif takes uint8 [F,H,W,3], not {frames.dtype} "
                         f"{frames.shape}")
    F, H, W, _ = frames.shape
    idx, palette = palette_indices(frames)
    table = np.zeros((256, 3), np.uint8)
    table[:len(palette)] = palette
    delay = int(round(100.0 / fps))
    parts = [b"GIF89a", struct.pack("<HHBBB", W, H, 0xF7, 0, 0), table.tobytes(),
             b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"]
    for f in range(F):
        parts += [b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00",
                  b"\x2c" + struct.pack("<HHHHB", 0, 0, W, H, 0),
                  b"\x08" + _sub_blocks(lzw_codes(idx[f]))]
    parts.append(b"\x3b")
    with open(path, "wb") as fh:
        fh.write(b"".join(parts))
