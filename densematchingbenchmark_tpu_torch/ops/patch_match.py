"""Differentiable PatchMatch disparity sampling (DeepPruner).

Counterpart of densematchingbenchmark_tpu/ops/patch_match.py:27-258, on
its ``'warp'`` scoring. Three phases, unrolled ``iterations`` times:
  init: one uniform sample per disparity interval (stratified particles);
  propagate: each pixel takes its neighbours' particles along W, then
    along H (the reference's one-hot separable convs: a shift-and-stack);
  evaluate: the inner-product matching score of the warped right
    features, a temperature softmax over each interval's candidates, and
    the soft-selected sample and noise per interval.

JAX's ``scoring='corr'`` (scores from one integer-shift correlation
volume contracted with static tent windows) computes the same scores by
the linearity of the dot product: a TPU schedule that the port does not
have (models/builder.py maps it to ``'warp'``).

The noise is an explicit tensor or comes from an explicit
``torch.Generator``, as JAX's comes from a PRNG key: ``eval_noise`` is the
eval draw (seeded 0, one batch-1 draw broadcast over the batch, so that a
sample's result does not depend on its batch), made once per shape and
device; in training the caller's generator draws [B, n, H, W] anew. In a
group of N processes each rank draws the global batch's [N B, n, H, W]
from its copy of the step's generator and keeps its own rows, as JAX draws
one global array from one key and shards it: a rank's noise is the rows a
one-process run at the global batch draws for the same samples. The JAX
PRNG and torch's cannot match bit for bit: the parity tests inject JAX's
draw through ``noise``.
"""


import torch
import torch.nn.functional as F

from ..parallel import collectives
from .kept import kept
from .warp import inverse_warp_3d


def _shift(x, off, axis):
    """out[..., p, ...] = x[..., p + off, ...], zero outside."""
    if off == 0:
        return x
    kept = x.narrow(axis, max(off, 0), x.shape[axis] - abs(off))
    pad = [0, 0] * (x.dim() - axis)
    pad[-2:] = (0, off) if off > 0 else (-off, 0)
    return F.pad(kept, pad)


def _propagate(x, axis, filter_size=3):
    """[B, N, H, W] -> [B, N * filter_size, H, W]: each sample's neighbours
    at offsets -(k // 2) .. k // 2 along ``axis``, grouped per interval
    (the reference's one-hot conv order)."""
    b, n, h, w = x.shape
    offs = range(-(filter_size // 2), filter_size // 2 + 1)
    stacked = torch.stack([_shift(x, o, axis) for o in offs], dim=2)
    return stacked.reshape(b, n * filter_size, h, w)


def _evaluate(left, right, samples, noise, filter_size, temperature):
    """The soft best of each interval's ``filter_size`` candidates: the
    score is the channel mean of left x warped right, in float32, times
    the temperature; softmax over the candidates; the samples and noise
    blended by it."""
    b, dk, h, w = samples.shape
    n = dk // filter_size
    warped, _ = inverse_warp_3d(right, samples)
    score = (left[:, None] * warped).mean(-1).float() * temperature
    prob = torch.softmax(score.reshape(b, n, filter_size, h, w), dim=2)
    samples = (prob * samples.reshape(b, n, filter_size, h, w)).sum(2)
    noise = (prob * noise.reshape(b, n, filter_size, h, w)).sum(2)
    return samples, noise


@kept(64)
def eval_noise(n, h, w, device):
    """The eval draw [1, n, H, W] on ``device``: uniform [0, 1) from a
    generator seeded 0, made once per key and kept (a copy from the host
    per call would make the call wait for the card). Callers must not
    write to it."""
    draw = torch.rand((1, n, h, w), generator=torch.Generator().manual_seed(
        0))
    with torch.inference_mode(False):   # usable later under autograd
        return draw.to(device)


def train_noise(b, n, h, w, generator):
    """This rank's [b, n, h, w] rows of the global batch's training draw
    [world_size * b, n, h, w] from ``generator`` (on its device)."""
    world, rank = collectives.world_size(), collectives.rank()
    noise = torch.rand((world * b, n, h, w), generator=generator,
                       device=generator.device)
    return noise if world == 1 else noise[rank * b:(rank + 1) * b]


def patch_match(left, right, min_disparity, max_disparity,
                disparity_sample_number=14, propagation_filter_size=3,
                iterations=3, temperature=7.0, noise=None, generator=None):
    """Per-pixel disparity samples by differentiable PatchMatch.

    Args:
      left, right: [B, H, W, C] features.
      min_disparity, max_disparity: [B, H, W, 1] search-range bounds.
      disparity_sample_number: samples returned, min and max included.
      noise: optional [B or 1, n, H, W] initial particles' noise in
        [0, 1) (n = disparity_sample_number - 2), broadcast over the batch
        when its batch is 1.
      generator: without ``noise``, the torch.Generator that draws it
        ([B, n, H, W], on the generator's device, then copied to the
        features' without a host sync; in a process group this rank's
        rows of the global batch's draw); without either, ``eval_noise``.

    Returns:
      [B, disparity_sample_number, H, W] float32 samples (min, the n
      generated, max).
    """
    b, h, w, _ = left.shape
    lo = min_disparity.float()[..., 0][:, None]          # [B, 1, H, W]
    hi = max_disparity.float()[..., 0][:, None]
    n = disparity_sample_number - 2
    if noise is None:
        if generator is None:
            noise = eval_noise(n, h, w, left.device)
        else:
            noise = train_noise(b, n, h, w, generator)
            if noise.device != left.device:
                # a host generator's draw: staged in pinned memory, so the
                # copy to the card does not block the host
                noise = noise.pin_memory().to(left.device, non_blocking=True)
    noise = noise.float().expand(b, n, h, w)
    interval = 1.0 / (n + 1)
    index = (torch.arange(1, n + 1, dtype=torch.float32, device=lo.device)
             / (n + 1))[None, :, None, None]
    interval_min = lo + (hi - lo) * index                 # [B, n, H, W]
    interval_min_rep = interval_min.repeat_interleave(
        propagation_filter_size, dim=1)
    samples = None
    for _ in range(iterations):
        for axis in (3, 2):          # horizontal (W), then vertical (H)
            noise_prop = _propagate(noise, axis, propagation_filter_size)
            samples = (hi - lo) * interval * noise_prop + interval_min_rep
            samples, noise = _evaluate(left, right, samples, noise_prop,
                                       propagation_filter_size, temperature)
    return torch.cat([lo, samples, hi], dim=1)


def uniform_sample(min_disparity, max_disparity, disparity_sample_number=9):
    """Evenly spaced samples between per-pixel bounds, both included:
    [B, disparity_sample_number, H, W] (JAX :222-236)."""
    lo = min_disparity[..., 0][:, None]
    hi = max_disparity[..., 0][:, None]
    n = disparity_sample_number - 2
    index = (torch.arange(1, n + 1, dtype=min_disparity.dtype,
                          device=lo.device) / (n + 1))[None, :, None, None]
    return torch.cat([lo, lo + (hi - lo) * index, hi], dim=1)


def adjust_sample_range(min_disparity, max_disparity,
                        disparity_sample_number, max_disp):
    """Stretch a predicted [min, max] range to at least
    ``disparity_sample_number`` wide, each bound moved by half the
    shortfall and clipped to [0, max_disp] (JAX :239-258, which follows
    upstream DeepPruner where the reference halves the bounds)."""
    g_lo = torch.minimum(min_disparity, max_disparity)
    g_hi = torch.maximum(min_disparity, max_disparity)
    overflow = (g_lo + disparity_sample_number - g_hi).clamp_min(0)
    new_lo = (g_lo - overflow / 2.0).clamp(0.0, max_disp)
    new_hi = (g_hi + overflow / 2.0).clamp(0.0, max_disp)
    return new_lo, new_hi
