"""Disparity warps along the width axis.

Counterpart of densematchingbenchmark_tpu/ops/warp.py:23-92: a stereo warp
moves a sample only along W, so it is a 1-D linear-interpolated gather with
zero padding outside the frame, in the exact mode and in the mode that
reproduces the reference's grid_sample numerics (``compat_grid_sample``),
its per-sample form ``inverse_warp_3d`` (JAX :95-155: DeepPruner's cost
volumes and PatchMatch scores), and the 2-D backward warp of the flow
models, ``flow_warp`` (JAX :156-183).
"""

import torch


def gather_1d_linear(src, x, axis):
    """Linear-interpolated gather along ``axis`` with zero padding.

    out[..., i, ...] = src[..., x[i], ...] for fractional x; each of the two
    integer taps adds nothing when it lies outside [0, W-1].

    Args:
      src: source tensor.
      x: fractional coordinates, broadcastable to src's shape with ``axis``
        replaced by the output length.
      axis: the axis of ``src`` being sampled.
    """
    w = src.shape[axis]
    x0 = torch.floor(x)
    frac = x - x0
    x0i = x0.long()

    def tap(xi, weight):
        valid = (xi >= 0) & (xi <= w - 1)
        g = torch.take_along_dim(src, xi.clamp(0, w - 1), dim=axis)
        return g * (weight * valid.to(x.dtype)).to(src.dtype)

    return tap(x0i, 1.0 - frac) + tap(x0i + 1, frac)


def inverse_warp_2d(img, disp, compat_grid_sample=False):
    """Warp ``img`` (the source view) to the reference view:
    out[b, y, x, c] = img[b, y, x + disp[b, y, x], c], linear, zero outside
    the frame. Warping the right view to the left uses
    ``disp = -left_disparity``.

    Args:
      img: [B, H, W, C].
      disp: [B, H, W, 1] or [B, H, W] horizontal offset added to x.
      compat_grid_sample: the reference's numerics: align_corners=True
        coordinates fed to an align_corners=False grid_sample rescale every
        axis p -> p * n/(n-1) - 0.5 (blending adjacent rows), and samples
        whose x before the rescale falls outside [0, W-1] are zeroed.
    """
    if disp.dim() == 4:
        disp = disp[..., 0]
    h, w = img.shape[1:3]
    xs = torch.arange(w, dtype=disp.dtype, device=disp.device) + disp
    if compat_grid_sample:
        inframe = (xs >= 0) & (xs <= w - 1)
        ys = (torch.arange(h, dtype=disp.dtype, device=disp.device)
              * (h / (h - 1)) - 0.5)
        img = gather_1d_linear(img, ys[None, :, None, None], axis=1)
        out = gather_1d_linear(img, (xs * (w / (w - 1)) - 0.5)[..., None],
                               axis=2)
        return out * inframe[..., None].to(out.dtype)
    return gather_1d_linear(img, xs[..., None], axis=2)


def _axis_pos(n, dtype, device):
    """Sample positions p * n / (n - 1) - 0.5 of grid_sample with
    align_corners=False on align_corners=True coordinates."""
    return torch.arange(n, dtype=dtype, device=device) * (n / (n - 1)) - 0.5


def _axis_border_scale(n, dtype, device):
    """The weight that survives the zero padding at each position of
    ``_axis_pos`` along an axis of constant values."""
    pos = _axis_pos(n, dtype, device)
    p0 = torch.floor(pos)
    frac = pos - p0
    w0 = torch.where((p0 >= 0) & (p0 <= n - 1), 1 - frac, 0.0)
    w1 = torch.where((p0 + 1 >= 0) & (p0 + 1 <= n - 1), frac, 0.0)
    return w0 + w1


def inverse_warp_3d(fm, disp_sample, compat_grid_sample=False):
    """Per-sample warp of a feature map along width:
    out[b, d, y, x, c] = fm[b, y, x - disp_sample[b, d, y, x], c], linear,
    zero outside the frame (the reference's trilinear grid_sample warp
    with ``-disp_sample``, whose D and H coordinates are the identity).

    Args:
      fm: [B, H, W, C] feature map (the target / right view).
      disp_sample: [B, D, H, W] per-pixel disparity samples.
      compat_grid_sample: the reference's numerics: align_corners=True
        coordinates sampled with align_corners=False rescale every axis
        p -> p * n/(n-1) - 0.5 (shifting W, blending adjacent rows of H,
        attenuating the first and last slices of D).

    Returns:
      (warped [B, D, H, W, C], valid [B, D, H, W, 1]): ``valid`` is 1
      where the sample position lies in [0, W - 1], in ``fm``'s dtype.
    """
    w = fm.shape[2]
    dtype, device = disp_sample.dtype, disp_sample.device
    xs = torch.arange(w, dtype=dtype, device=device) - disp_sample
    if compat_grid_sample:
        h, d = fm.shape[1], disp_sample.shape[1]
        fm = gather_1d_linear(fm, _axis_pos(h, dtype, device)[
            None, :, None, None], axis=1)
        xs = xs * (w / (w - 1)) - 0.5
        warped = gather_1d_linear(fm[:, None], xs[..., None], axis=3)
        warped = warped * _axis_border_scale(d, warped.dtype, device)[
            None, :, None, None, None]
    else:
        warped = gather_1d_linear(fm[:, None], xs[..., None], axis=3)
    valid = ((xs >= 0) & (xs <= w - 1)).to(fm.dtype)[..., None]
    return warped, valid


def flow_warp(img, flow):
    """Warp ``img`` backward by a 2-D flow field:
    out[b, y, x, c] = img[b, y + flow[b, y, x, 1], x + flow[b, y, x, 0], c],
    bilinear, zero outside the frame: two chained 1-D linear gathers, W
    then H, as JAX's (the H gather reads the rows the W gather warped, so
    a row y' = y + v takes its own u: the 2-D warp where the flow is
    smooth). The sample positions are computed in the flow's dtype
    (PWCFlow hands a bfloat16 flow to bfloat16 features, as JAX's).

    Args:
      img: [B, H, W, C] source features (frame t + 1).
      flow: [B, H, W, 2] (u, v) displacement in pixels.
    """
    h, w = img.shape[1:3]
    dtype, device = flow.dtype, flow.device
    xs = torch.arange(w, device=device).to(dtype) + flow[..., 0]
    ys = torch.arange(h, device=device).to(dtype)[:, None] + flow[..., 1]
    out = gather_1d_linear(img, xs[..., None], axis=2)
    return gather_1d_linear(out, ys[..., None], axis=1)
