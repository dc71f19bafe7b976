"""Cost-volume construction (concatenation), fixed-range path.

Counterpart of densematchingbenchmark_tpu/ops/cost_volume.py:30-75. The
per-pixel ``disp_sample`` path arrives with the slice that ports
``ops/warp.py``.
"""

import functools

import numpy as np
import torch


def disp_sample_values(max_disp, start_disp=0, dilation=1):
    """The disparity value of each volume slice, as a float32 numpy array.

    np.linspace(start, start + max_disp - 1, D) with
    D = (max_disp + dilation - 1) // dilation. For dilation > 1 these are
    not start + i * dilation: max_disp=6, start=-2, dilation=2 gives
    -2, 0.5, 3.
    """
    end_disp = start_disp + max_disp - 1
    num = (max_disp + dilation - 1) // dilation
    return np.linspace(start_disp, end_disp, num, dtype=np.float32)


@functools.lru_cache(maxsize=256)
def disp_sample_tensor(max_disp, start_disp, dilation, device):
    """``disp_sample_values`` as a float32 tensor on ``device``, made once
    per key and kept (a copy from the host per call would make every call
    on the card wait for the work queued before it). Callers must not
    write to it."""
    with torch.inference_mode(False):   # usable later under autograd
        return torch.as_tensor(
            disp_sample_values(max_disp, start_disp, dilation), device=device)


def cat_volume(reference_fm, target_fm, max_disp, start_disp=0, dilation=1):
    """Concatenation cost volume.

    For each sample value v (shift d = int(v)):
    ``vol[:, i, :, x] = concat(ref[:, :, x], tgt[:, :, x - d])`` where
    0 <= x - d < W, and zero (both halves) elsewhere.

    Args:
      reference_fm, target_fm: [B, H, W, C] left/right features.

    Returns:
      [B, D, H, W, 2C] volume, reference channels first, NDHWC contiguous.
    """
    b, h, w, c = reference_fm.shape
    vals = disp_sample_values(max_disp, start_disp, dilation)
    vol = reference_fm.new_zeros((b, len(vals), h, w, 2 * c))
    for i, val in enumerate(vals):
        d = int(val)  # each sample is shifted by its value cast to int
        lo, hi = max(0, d), min(w, w + d)
        if lo >= hi:
            continue
        vol[:, i, :, lo:hi, :c] = reference_fm[:, :, lo:hi]
        vol[:, i, :, lo:hi, c:] = target_fm[:, :, lo - d:hi - d]
    return vol
