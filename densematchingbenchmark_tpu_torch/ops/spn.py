"""SPN gate-recurrent 2-D propagation (AnyNet's refinement).

Counterpart of densematchingbenchmark_tpu/ops/spn.py:27-87. Sweeping
left to right, column by column:

    H[b, h, w, c] = (1 - G1 - G2 - G3) * X
                  + G1 * H[b, h - 1, w - 1, c]     (upper-left neighbour)
                  + G2 * H[b, h,     w - 1, c]     (left neighbour)
                  + G3 * H[b, h + 1, w - 1, c]     (lower-left neighbour)

with the gates taken at [b, h, w, c] and zeros outside the frame; the
other three directions are the same sweep on a flipped or transposed
tensor, by JAX's flips and transposes.

This is not a TPU kernel: JAX runs the sweep as ``lax.scan``, and the port
runs it as a plain PyTorch loop over columns carrying [B, H, C], which
autograd differentiates. A column costs four launches: one padded copy of
the carry (a concatenation with a kept zero row on each side; its rows
shifted up and down are views of it) and three fused multiply-adds onto
keep * X, which is made once before the loop. The operands are split into
their columns by ``unbind``, whose gradient is one stack, where indexing a
column would write a full-size zero gradient for each.
"""

import torch


def _scan_left_right(x, g1, g2, g3):
    """All inputs [B, H, W, C]; returns the propagated [B, H, W, C]."""
    b, h, _, c = x.shape
    # the columns [B, H, C], each contiguous
    kx, g1, g2, g3 = (t.movedim(2, 0).contiguous().unbind(0)
                      for t in ((1.0 - g1 - g2 - g3) * x, g1, g2, g3))
    zero = x.new_zeros((b, 1, c))
    carry = x.new_zeros((b, h, c))
    out = []
    for i in range(len(kx)):
        padded = torch.cat([zero, carry, zero], 1)           # [B, H + 2, C]
        col = torch.addcmul(kx[i], g1[i], padded[:, :h])     # row h - 1
        col = torch.addcmul(col, g2[i], carry)
        carry = torch.addcmul(col, g3[i], padded[:, 2:])      # row h + 1
        out.append(carry)
    return torch.stack(out, 2)


def gate_recurrent_2d(x, g1, g2, g3, horizontal=True, reverse=False):
    """Gated linear 2-D propagation over [B, H, W, C] tensors.

    Args:
      x: input features.
      g1, g2, g3: gates of the three trailing neighbours of the sweep
        (up-stream left / centre / right).
      horizontal: sweep along the width (True) or the height (False).
      reverse: sweep from the far edge back.
    """
    tensors = (x, g1, g2, g3)
    if not horizontal:
        tensors = tuple(t.transpose(1, 2) for t in tensors)
    if reverse:
        tensors = tuple(t.flip(2) for t in tensors)
    out = _scan_left_right(*tensors)
    if reverse:
        out = out.flip(2)
    if not horizontal:
        out = out.transpose(1, 2).contiguous()
    return out


def normalize_gates(g1, g2, g3, eps=1e-8):
    """Scale the gates so that |G1| + |G2| + |G3| <= 1 at each pixel (JAX
    ops/spn.py:83-87)."""
    s = g1.abs() + g2.abs() + g3.abs() + eps
    return g1 / s, g2 / s, g3 / s
