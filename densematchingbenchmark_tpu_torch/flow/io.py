"""Optical-flow files (.flo, the Middlebury format).

Counterpart of densematchingbenchmark_tpu/flow/io.py, kept as this
package's own copy: the magic float 202021.25, int32 width, int32 height,
then H * W * 2 little-endian float32 (u, v interleaved).
"""

import numpy as np

_MAGIC = 202021.25


def load_flo(path):
    """Read a .flo file -> [H, W, 2] float32 (u, v)."""
    with open(path, "rb") as fp:
        magic = np.fromfile(fp, "<f4", 1)[0]
        if abs(magic - _MAGIC) > 1e-3:
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = int(np.fromfile(fp, "<i4", 1)[0])
        h = int(np.fromfile(fp, "<i4", 1)[0])
        data = np.fromfile(fp, "<f4", h * w * 2)
    return data.reshape(h, w, 2)


def save_flo(path, flow):
    """Write [H, W, 2] float32 as .flo."""
    flow = np.asarray(flow, np.float32)
    h, w, c = flow.shape
    if c != 2:
        raise ValueError(f"a flow field has 2 channels, got {c}")
    with open(path, "wb") as fp:
        np.asarray([_MAGIC], "<f4").tofile(fp)
        np.asarray([w, h], "<i4").tofile(fp)
        flow.astype("<f4").tofile(fp)
