"""A PNG writer with a mix of row filters, for the benchmark's image and
disparity files.

Real encoders choose a filter for each row; the decoders' cost depends
on that choice (Average and Paeth rows carry a dependence along the
row). ``encode`` filters each row with the type drawn for it from a
mix ({'none': share, 'sub': ..., 'up': ..., 'average': ..., 'paeth':
...}), then deflates the whole at ``level``. 8-bit RGB or 16-bit gray.
"""

import struct
import zlib

import numpy as np

FILTERS = ("none", "sub", "up", "average", "paeth")
SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def row_filters(mix, rows, rng):
    """[rows] uint8 filter types drawn from ``mix``."""
    share = np.array([float(mix.get(f, 0.0)) for f in FILTERS])
    if share.sum() <= 0:
        raise ValueError(f"empty filter mix {mix}")
    return rng.choice(len(FILTERS), size=rows,
                      p=share / share.sum()).astype(np.uint8)


def encode(img, types, level=6):
    """uint8 [H, W, 3] or uint16 [H, W] -> PNG bytes, row y filtered with
    ``types[y]``."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        color, depth, bpp = 2, 8, 3
    elif img.dtype == np.uint16 and img.ndim == 2:
        color, depth, bpp = 0, 16, 2
    else:
        raise ValueError(f"PNG of {img.dtype} {img.shape}: uint8 RGB or "
                         "uint16 gray")
    h, w = img.shape[:2]
    raw = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))) \
        .view(np.uint8).reshape(h, -1).astype(np.int16)
    left = np.pad(raw, ((0, 0), (bpp, 0)))[:, :-bpp]
    up = np.pad(raw, ((1, 0), (0, 0)))[:-1]
    upleft = np.pad(up, ((0, 0), (bpp, 0)))[:, :-bpp]
    preds = np.stack([np.zeros_like(raw), left, up, (left + up) >> 1,
                      _paeth(left, up, upleft)])
    pred = preds[np.asarray(types, np.int64), np.arange(h)]
    rows = ((raw - pred) & 255).astype(np.uint8)
    body = np.concatenate([np.asarray(types, np.uint8)[:, None], rows], 1)

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    return (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                         0, 0))
            + chunk(b"IDAT", zlib.compress(body.tobytes(), level))
            + chunk(b"IEND", b""))
