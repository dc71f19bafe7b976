"""Cost-volume construction (concatenation, difference and 1-D
correlation): the fixed-range path and the per-pixel ``disp_sample`` path
(DeepPruner's); and the flow models' local 2-D correlation,
``correlation2d_volume``.

Counterpart of densematchingbenchmark_tpu/ops/cost_volume.py:30-177. The
per-pixel path warps the target features with ``warp.inverse_warp_3d``
and zeroes the reference features where the warp left the frame (the
reference's exact path; with ``compat_grid_sample`` its fast path's
masking quirk, the reference zeroed where the warped value is <= 0).
"""


import numpy as np
import torch

from .kept import kept
from .warp import inverse_warp_3d


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


@kept(256)
def disp_sample_tensor(max_disp, start_disp, dilation, device):
    """``disp_sample_values`` as a float32 tensor on ``device``, made once
    per key and kept (a copy from the host per call would make every call
    on the card wait for the work queued before it). Callers must not
    write to it."""
    with torch.inference_mode(False):   # usable later under autograd
        return torch.as_tensor(
            disp_sample_values(max_disp, start_disp, dilation), device=device)


def _warped(reference_fm, target_fm, disp_sample, compat_grid_sample):
    """(reference features masked [B, D, H, W, C] or broadcastable, warped
    target features [B, D, H, W, C]) of the per-pixel path."""
    warped, valid = inverse_warp_3d(target_fm, disp_sample,
                                    compat_grid_sample=compat_grid_sample)
    if compat_grid_sample:
        valid = (warped > 0).to(warped.dtype)
    return reference_fm[:, None] * valid, warped


def cat_volume(reference_fm, target_fm, max_disp, start_disp=0, dilation=1,
               disp_sample=None, compat_grid_sample=False):
    """Concatenation cost volume.

    For each sample value v (shift d = int(v)):
    ``vol[:, i, :, x] = concat(ref[:, :, x], tgt[:, :, x - d])`` where
    0 <= x - d < W, and zero (both halves) elsewhere. With ``disp_sample``
    [B, D, H, W] (per-pixel samples, sub-pixel): the target warped by
    each sample (linear, zero outside the frame) after the reference
    features, zeroed where the sample position leaves [0, W - 1].

    Args:
      reference_fm, target_fm: [B, H, W, C] left/right features.

    Returns:
      [B, D, H, W, 2C] volume, reference channels first, NDHWC contiguous.
    """
    if disp_sample is not None:
        ref, warped = _warped(reference_fm, target_fm, disp_sample,
                              compat_grid_sample)
        return torch.cat([ref.expand_as(warped), warped], -1)
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


def dif_volume(reference_fm, target_fm, max_disp, start_disp=0, dilation=1,
               disp_sample=None, normalize=False, p=1.0,
               compat_grid_sample=False):
    """Difference cost volume (StereoNet's).

    For each sample value v (shift d = int(v)):
    ``vol[:, i, :, x] = ref[:, :, x] - tgt[:, :, x - d]`` where
    0 <= x - d < W, and zero elsewhere; with ``normalize`` the p-norm over
    the channels, ``sum(|vol|)`` for p = 1.

    Args:
      reference_fm, target_fm: [B, H, W, C] left/right features.
      disp_sample: optional [B, D, H, W] per-pixel samples: the masked
        reference minus the warped target (``cat_volume``'s halves).

    Returns:
      [B, D, H, W, C] volume, or [B, D, H, W] with ``normalize``.
    """
    if disp_sample is not None:
        ref, warped = _warped(reference_fm, target_fm, disp_sample,
                              compat_grid_sample)
        vol = ref - warped
    else:
        b, h, w, c = reference_fm.shape
        vals = disp_sample_values(max_disp, start_disp, dilation)
        vol = reference_fm.new_zeros((b, len(vals), h, w, c))
        for i, val in enumerate(vals):
            d = int(val)  # each sample is shifted by its value cast to int
            lo, hi = max(0, d), min(w, w + d)
            if lo < hi:
                vol[:, i, :, lo:hi] = (reference_fm[:, :, lo:hi]
                                       - target_fm[:, :, lo - d:hi - d])
    if normalize:
        if p == 1.0:
            return vol.abs().sum(-1)
        return vol.abs().pow(p).sum(-1).pow(1.0 / p)
    return vol


def correlation1d_volume(reference_fm, target_fm, max_disp, start_disp=0,
                         dilation=1, disp_sample=None, leaky_slope=0.1):
    """1-D correlation cost: the channel dot product at each disparity,
    then a leaky ReLU.

    For each sample value v (shift d = int(v)):
    ``cost[:, i, :, x] = sum_c ref[:, :, x, c] * tgt[:, :, x - d, c]`` where
    0 <= x - d < W, and zero elsewhere. With ``disp_sample`` [B, D, H, W]
    (per-pixel samples, sub-pixel): the dot product of the reference with
    the target warped by each sample (linear, zero outside the frame; the
    reference is not masked). Disparity runs 0 -> max_disp - 1 along D, as
    in the JAX package (the reference's patch order runs it backwards). The
    channel sum accumulates in float32 and is rounded to the features'
    dtype once.

    Args:
      reference_fm, target_fm: [B, H, W, C] left/right features.

    Returns:
      [B, D, H, W] in the features' dtype.
    """
    dtype = reference_fm.dtype
    ref, tgt = reference_fm.float(), target_fm.float()
    if disp_sample is not None:
        warped, _ = inverse_warp_3d(tgt, disp_sample.float())
        cost = torch.einsum("bhwc,bdhwc->bdhw", ref, warped)
    else:
        b, h, w, _ = ref.shape
        vals = disp_sample_values(max_disp, start_disp, dilation)
        cost = ref.new_zeros((b, len(vals), h, w))
        for i, val in enumerate(vals):
            d = int(val)  # each sample is shifted by its value cast to int
            lo, hi = max(0, d), min(w, w + d)
            if lo < hi:
                cost[:, i, :, lo:hi] = torch.einsum(
                    "bhwc,bhwc->bhw", ref[:, :, lo:hi],
                    tgt[:, :, lo - d:hi - d])
    return torch.nn.functional.leaky_relu(cost.to(dtype), leaky_slope)


def correlation2d_volume(reference_fm, target_fm, radius, dilation=1):
    """Local 2-D correlation volume (PWCFlow's):
    cost[b, y, x, k] = mean_c ref[b, y, x, c] * tgt[b, y + dy, x + dx, c]
    for the (2 radius + 1)^2 displacements (dy, dx), row-major, each in
    -radius * dilation .. radius * dilation by ``dilation``; zero where the
    displaced sample leaves the frame.

    One batched product per row offset dy: the padded target's rows at dy,
    unfolded over the 2 radius + 1 column offsets, contracted with the
    reference over the channels (2 radius + 1 matmuls, where a product
    per displacement would be (2 radius + 1)^2 launches of each op).

    Args:
      reference_fm, target_fm: [B, H, W, C].

    Returns:
      [B, H, W, (2 radius + 1)^2] in the features' dtype.
    """
    b, h, w, c = reference_fm.shape
    n, r = 2 * radius + 1, radius * dilation
    padded = torch.nn.functional.pad(target_fm, (0, 0, r, r, r, r))
    ref = reference_fm.reshape(b * h * w, 1, c)
    rows = []
    for dy in range(0, 2 * r + 1, dilation):
        # [B, H, W, C, n]: the n column offsets of each pixel's window
        win = padded[:, dy:dy + h].unfold(2, 2 * r + 1, 1)[..., ::dilation]
        rows.append(torch.bmm(ref, win.reshape(b * h * w, c, n)))
    cost = torch.cat(rows, dim=1) / c
    return cost.reshape(b, h, w, n * n)
