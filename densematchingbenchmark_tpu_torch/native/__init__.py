"""ctypes bindings of the port's host library, the data pipeline's
decoders (csrc/dmb_native.cpp).

Counterpart of densematchingbenchmark_tpu/native/__init__.py:1-110, with
its names: ``available()``, ``decode_pfm(path)``, ``decode_png_rgb(path)``,
``decode_png_disp16(path)``, ``normalize_crop(src, y1, x1, th, tw, mean,
std)``. JAX's library links libpng; this one needs no library: Python
reads the file, walks the PNG chunks with their CRCs and inflates the
image data with zlib (``data/io.png_stream``), and one ctypes call undoes
the row filters and writes float32 into an array numpy allocated. The
library is built with g++ at first use (``ops/cuda/_build``); a failed
build raises with g++'s output, and nothing falls back to numpy.

The PNG decoders read what ``data/io.decode_png`` (their plain version)
reads, 8- and 16-bit gray, gray+alpha, RGB and RGBA, not interlaced, and
refuse the rest with its ValueError. ctypes releases the GIL for the
call, and zlib for the inflate, so decoders in several threads overlap.

Where JAX's two readers differ, the port keeps the result its readers
gave before (ROADMAP §3): 16-bit samples stay 0-65535 (JAX's native
scales them by 255/65535); alpha is dropped (JAX's composites onto black);
a disparity PNG of C > 1 channels keeps them, [H, W, C] / 256 (JAX's
takes their luminance); a gAMA chunk is ignored (JAX's applies it); and
``read_pfm`` returns the file's |scale| (JAX's native branch 1.0).
"""

import ctypes

import numpy as np

from ..data import io as _io
from ..ops.cuda import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "dmb_pfm_rows": ([_P, _I, _I, _I, _I, _P], _I),
    "dmb_png_decode": ([_P, _I, _I, _I, _I, _I, _P], _I),
    "dmb_normalize_crop": ([_P] + [_I] * 7 + [_P] * 3, None),
}


def _lib():
    return _build.load("dmb_native", _SIGNATURES)


def available():
    """True when the library is built, or builds here, and loads."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def _read(path):
    with open(path, "rb") as fp:
        return fp.read()


def _address(buf, offset=0):
    return np.frombuffer(buf, np.uint8, offset=offset).ctypes.data


def decode_png(data, disparity=False):
    """PNG bytes -> float32: an image [H, W, 3] (gray repeated, alpha
    dropped), or with ``disparity`` the samples / 256, [H, W] (gray) or
    [H, W, C]. Bitwise ``data/io.decode_png``'s samples so converted."""
    h, w, depth, channels, stream = _io.png_stream(data)
    shape = ((h, w) if channels == 1 else (h, w, channels)) if disparity \
        else (h, w, 3)
    out = np.empty(shape, np.float32)
    worst = _lib().dmb_png_decode(_address(stream), h, w, channels, depth,
                                  int(disparity), out.ctypes.data)
    if worst:
        raise ValueError(f"PNG row filter {worst} is not defined")
    return out


def decode_png_rgb(path):
    """An image PNG -> float32 [H, W, 3]."""
    return decode_png(_read(path))


def decode_png_disp16(path):
    """A KITTI disparity PNG -> float32 [H, W], value / 256 (0 = invalid)."""
    return decode_png(_read(path), disparity=True)


def read_pfm(path):
    """A PFM file -> (float32 [H, W] or [H, W, 3] top-down, |scale|)."""
    data = _read(path)
    h, w, c, scale, pos = _io.pfm_header(data, path)
    out = np.empty((h, w, 3) if c == 3 else (h, w), np.float32)
    _lib().dmb_pfm_rows(_address(data, pos), h, w, c, int(scale < 0),
                        out.ctypes.data)
    return out, abs(scale)


def decode_pfm(path):
    """A PFM file -> float32 [H, W] or [H, W, 3], top-down."""
    return read_pfm(path)[0]


def normalize_crop(src, y1, x1, th, tw, mean, std):
    """(src[y1:y1+th, x1:x1+tw] - mean) / std per channel -> float32
    [th, tw, C] (C = 1 for a 2-D ``src``), in one pass."""
    src = np.ascontiguousarray(src, np.float32)
    h, w = src.shape[:2]
    c = src.shape[2] if src.ndim == 3 else 1
    if not (0 <= y1 and 0 <= x1 and th >= 0 and tw >= 0
            and y1 + th <= h and x1 + tw <= w):
        raise ValueError(f"crop {th}x{tw} at ({y1}, {x1}) leaves the "
                         f"{h}x{w} image")
    mean = np.ascontiguousarray(mean, np.float32).reshape(-1)
    std = np.ascontiguousarray(std, np.float32).reshape(-1)
    if mean.size != c or std.size != c:
        raise ValueError(f"{c} channels, {mean.size} means and {std.size} "
                         "standard deviations")
    dst = np.empty((th, tw, c), np.float32)
    _lib().dmb_normalize_crop(src.ctypes.data, h, w, c, y1, x1, th, tw,
                              mean.ctypes.data, std.ctypes.data,
                              dst.ctypes.data)
    return dst
