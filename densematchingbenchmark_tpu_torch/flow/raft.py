"""RAFT: recurrent all-pairs field transforms, the second flow family.

Counterpart of densematchingbenchmark_tpu/flow/raft.py:34-311:

- a stride-8 residual encoder for features (``fnet``, called on both
  frames: its BN statistics move twice in a training step, in order) and
  one for context (``cnet``: tanh hidden state, ReLU context);
- the all-pairs correlation of the two feature maps, one float32 batched
  matmul scaled by 1/sqrt(C) (TF32 off on the card), average-pooled over
  the target's dims into ``levels`` levels;
- ``iters`` iterations of one weight-tied ``UpdateBlock`` (JAX's
  ``nn.scan`` with the parameters broadcast: one set of weights, no
  iteration axis), here a Python loop: the lookup of a (2 radius + 1)^2
  window of every level around the current correspondence, a motion
  encoder, a ConvGRU and a flow head adding a float32 delta;
- the learned convex 8x upsampler of the final flow, and each
  iteration's flow upsampled bilinearly 8x (align_corners=True), latest
  first.

The lookup (``corr_lookup``) samples each level bilinearly with zero
padding as two batched matmuls with "two-hot" tent rows, the form of
JAX's ``corr_lookup``: on the card a level's lookup is 14 launches (the
tents and two matmuls), where the chained 1-D gathers of JAX's
``corr_lookup_gather`` take about 40; both JAX forms are its oracle on
the CPU.

In bfloat16: the correlation, the lookup, the hidden state between
iterations, the flows and the upsampler's softmax and combination are
float32, the convolutions bfloat16, as JAX's. Modules take and return
[B, H, W, C] maps; submodule names follow the Flax tree (``fnet``,
``cnet``, ``update`` with ``MotionEncoder_0``, ``ConvGRU_0`` (``z``,
``r``, ``q``), ``flow_head1``, ``flow_head2``, and
``ConvexUpsampler_0``).
"""

import math

import torch
from torch import nn

from ..models.layers import ConvUnit
from ..ops.interpolate import upsample_2d


class ResUnit(nn.Module):
    def __init__(self, in_features, features, stride=1, batch_norm=True,
                 dtype=torch.float32):
        super().__init__()
        self.ConvUnit_0 = ConvUnit(in_features, features, stride=stride,
                                   batch_norm=batch_norm, dtype=dtype)
        self.ConvUnit_1 = ConvUnit(features, features, batch_norm=batch_norm,
                                   relu=False, dtype=dtype)
        self.ConvUnit_2 = None
        if in_features != features or stride != 1:
            self.ConvUnit_2 = ConvUnit(in_features, features, 1, stride, 0,
                                       batch_norm=batch_norm, relu=False,
                                       dtype=dtype)

    def forward(self, x):
        y = self.ConvUnit_1(self.ConvUnit_0(x))
        if self.ConvUnit_2 is not None:
            x = self.ConvUnit_2(x)
        return torch.relu(x + y)


class RaftEncoder(nn.Module):
    """7x7 stride-2 unit, two residual units per width (the first of each
    later width at stride 2), a 1x1 projection: [B, H/8, W/8, out]."""

    def __init__(self, chans=(32, 64, 96), out_features=128, batch_norm=True,
                 dtype=torch.float32):
        super().__init__()
        self.ConvUnit_0 = ConvUnit(3, chans[0], 7, 2, 3,
                                   batch_norm=batch_norm, dtype=dtype)
        cin, i = chans[0], 0
        for c in chans:
            stride = 1 if c == chans[0] else 2
            for s in (stride, 1):
                setattr(self, f"ResUnit_{i}",
                        ResUnit(cin, c, s, batch_norm, dtype))
                cin, i = c, i + 1
        self.res_units = 2 * len(chans)
        self.ConvUnit_1 = ConvUnit(cin, out_features, 1, padding=0,
                                   batch_norm=False, relu=False, dtype=dtype)

    def forward(self, x):
        x = self.ConvUnit_0(x)
        for i in range(self.res_units):
            x = getattr(self, f"ResUnit_{i}")(x)
        return self.ConvUnit_1(x)


def all_pairs_corr_pyramid(fm1, fm2, levels=4):
    """[B, h, w, C] x [B, h, w, C] -> [corr_l: [B, h, w, h / 2^l, w / 2^l]]
    float32: every pair's dot product over sqrt(C), then the target's dims
    average-pooled 2x2 per level (an odd trailing row or column cropped
    first); stops early when a target dim would reach 0, as JAX's."""
    b, h, w, c = fm1.shape
    a = fm1.reshape(b, h * w, c).float()
    t = fm2.reshape(b, h * w, c).float()
    corr = torch.bmm(a, t.transpose(1, 2)) / math.sqrt(c)
    pyramid = [corr.reshape(b, h, w, h, w)]
    for _ in range(levels - 1):
        ch, cw = pyramid[-1].shape[3:5]
        ch2, cw2 = ch // 2, cw // 2
        if ch2 == 0 or cw2 == 0:
            break
        p = pyramid[-1][:, :, :, :2 * ch2, :2 * cw2]
        pyramid.append(p.reshape(b, h, w, ch2, 2, cw2, 2).mean(dim=(4, 6)))
    return pyramid


def _tent_weights(coords, size):
    """[..., k] fractional coordinates -> [..., k, size] linear
    interpolation weights max(0, 1 - |coord - cell|): a coordinate's two
    taps, a tap outside [0, size - 1] dropped (zero padding)."""
    cells = torch.arange(size, device=coords.device, dtype=torch.float32)
    return (1.0 - (coords[..., None] - cells).abs()).clamp_min(0.0)


def corr_lookup(pyramid, coords, radius=3):
    """Bilinear samples of each level in a (2 radius + 1)^2 window around
    ``coords`` ([B, h, w, 2] float32 (x, y) at level 0, scaled by 2^-l at
    level l), zero outside: [B, h, w, levels * (2 radius + 1)^2], each
    level's window row-major in (dy, dx)."""
    b, h, w = coords.shape[:3]
    n_px, n = b * h * w, 2 * radius + 1
    offs = torch.arange(-radius, radius + 1, device=coords.device,
                        dtype=torch.float32)
    cx = coords[..., 0].reshape(n_px, 1)
    cy = coords[..., 1].reshape(n_px, 1)
    feats = []
    for lvl, corr in enumerate(pyramid):
        ch, cw = corr.shape[3:5]
        scale = 0.5 ** lvl
        wy = _tent_weights(cy * scale + offs, ch)            # [N, n, ch]
        wx = _tent_weights(cx * scale + offs, cw)            # [N, n, cw]
        rows = torch.bmm(wy, corr.reshape(n_px, ch, cw))      # [N, n, cw]
        feats.append(torch.bmm(rows, wx.transpose(1, 2)).reshape(
            b, h, w, n * n))
    return torch.cat(feats, dim=-1)


class ConvGRU(nn.Module):
    def __init__(self, in_features, hidden=96, dtype=torch.float32):
        super().__init__()
        for name in ("z", "r", "q"):
            setattr(self, name, ConvUnit(hidden + in_features, hidden,
                                         batch_norm=False, relu=False,
                                         dtype=dtype))

    def forward(self, h, x):
        hx = torch.cat([h, x], dim=-1)
        z = torch.sigmoid(self.z(hx))
        r = torch.sigmoid(self.r(hx))
        q = torch.tanh(self.q(torch.cat([r * h, x], dim=-1)))
        return (1.0 - z) * h + z * q


class MotionEncoder(nn.Module):
    """[corr features | flow] -> 80 motion channels and the flow: 82."""

    def __init__(self, corr_features, dtype=torch.float32):
        super().__init__()
        self.ConvUnit_0 = ConvUnit(corr_features, 96, 1, padding=0,
                                   batch_norm=False, dtype=dtype)
        self.ConvUnit_1 = ConvUnit(96, 64, batch_norm=False, dtype=dtype)
        self.ConvUnit_2 = ConvUnit(2, 32, 7, padding=3, batch_norm=False,
                                   dtype=dtype)
        self.ConvUnit_3 = ConvUnit(32, 16, batch_norm=False, dtype=dtype)
        self.ConvUnit_4 = ConvUnit(80, 80, batch_norm=False, dtype=dtype)

    def forward(self, corr_feat, flow):
        c = self.ConvUnit_1(self.ConvUnit_0(corr_feat))
        f = self.ConvUnit_3(self.ConvUnit_2(flow.to(c.dtype)))
        out = self.ConvUnit_4(torch.cat([c, f], dim=-1))
        return torch.cat([out, flow.to(out.dtype)], dim=-1)


class ConvexUpsampler(nn.Module):
    """Learned 8x upsampling: per output pixel a float32 softmax over the
    3x3 coarse neighbourhood (mask channel p * 9 + k, phase p = py * 8 +
    px, tap k row-major), the taps from a zero-padded flow."""

    def __init__(self, in_features, dtype=torch.float32):
        super().__init__()
        self.ConvUnit_0 = ConvUnit(in_features, 128, batch_norm=False,
                                   dtype=dtype)
        self.ConvUnit_1 = ConvUnit(128, 64 * 9, 1, padding=0,
                                   batch_norm=False, relu=False, dtype=dtype)

    def forward(self, hidden, flow):
        b, h, w, _ = flow.shape
        mask = self.ConvUnit_1(self.ConvUnit_0(hidden))
        mask = torch.softmax(mask.reshape(b, h, w, 64, 9).float(), dim=-1)
        padded = nn.functional.pad(flow, (0, 0, 1, 1, 1, 1))
        nb = torch.stack([padded[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                          for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
                         dim=3)                          # [B, h, w, 9, 2]
        up = torch.matmul(mask, nb) * 8.0                # [B, h, w, 64, 2]
        up = up.reshape(b, h, w, 8, 8, 2).permute(0, 1, 3, 2, 4, 5)
        return up.reshape(b, 8 * h, 8 * w, 2)


class UpdateBlock(nn.Module):
    """One iteration: lookup -> motion encoder -> ConvGRU -> delta flow."""

    def __init__(self, corr_features, context, hidden=96, radius=3,
                 dtype=torch.float32):
        super().__init__()
        self.radius, self.dtype = radius, dtype
        self.MotionEncoder_0 = MotionEncoder(corr_features, dtype)
        self.ConvGRU_0 = ConvGRU(82 + context, hidden, dtype)
        self.flow_head1 = ConvUnit(hidden, 128, batch_norm=False, dtype=dtype)
        self.flow_head2 = ConvUnit(128, 2, batch_norm=False, relu=False,
                                   dtype=dtype)

    def forward(self, hid, flow, pyramid, context, base):
        corr_feat = corr_lookup(pyramid, base + flow, self.radius)
        x = torch.cat([self.MotionEncoder_0(corr_feat.to(self.dtype), flow),
                       context.to(self.dtype)], dim=-1)
        hid = self.ConvGRU_0(hid.to(self.dtype), x).float()
        delta = self.flow_head2(self.flow_head1(hid.to(self.dtype)))
        return hid, flow + delta.float()


class RAFTFlow(nn.Module):
    """forward(ref, tgt) with [B, H, W, 3] frames (sides multiples of 8,
    the 1/8-scale map at least 2^(levels - 1) on each side) ->
    {'flows': [B, H, W, 2] float32}: the convex-upsampled final flow, then
    each iteration's, latest first (1 + iters)."""

    def __init__(self, iters=8, radius=3, levels=4, hidden=96, context=64,
                 batch_norm=True, dtype=torch.float32):
        super().__init__()
        self.iters, self.levels, self.dtype = iters, levels, dtype
        self.hidden = hidden
        self.fnet = RaftEncoder(out_features=128, batch_norm=batch_norm,
                                dtype=dtype)
        self.cnet = RaftEncoder(out_features=hidden + context,
                                batch_norm=batch_norm, dtype=dtype)
        self.update = UpdateBlock(levels * (2 * radius + 1) ** 2, context,
                                  hidden, radius, dtype)
        self.ConvexUpsampler_0 = ConvexUpsampler(hidden, dtype)

    def forward(self, ref_img, tgt_img):
        b, h, w, _ = ref_img.shape
        fh, fw = h // 8, w // 8
        fm1 = self.fnet(ref_img.to(self.dtype))
        fm2 = self.fnet(tgt_img.to(self.dtype))
        cnet = self.cnet(ref_img.to(self.dtype))
        hid = torch.tanh(cnet[..., :self.hidden].float())
        context = torch.relu(cnet[..., self.hidden:])
        pyramid = all_pairs_corr_pyramid(fm1, fm2, self.levels)
        if len(pyramid) < self.levels:
            raise ValueError(
                f"RAFT: a {h}x{w} frame gives a {fh}x{fw} map at 1/8, "
                f"{len(pyramid)} correlation levels of the {self.levels} "
                f"the model is built for (each side of the 1/8 map must "
                f"be at least {2 ** (self.levels - 1)})")
        ys, xs = torch.meshgrid(
            torch.arange(fh, device=ref_img.device, dtype=torch.float32),
            torch.arange(fw, device=ref_img.device, dtype=torch.float32),
            indexing="ij")
        base = torch.stack([xs, ys], dim=-1)[None]          # [1, fh, fw, 2]
        flow = base.new_zeros((b, fh, fw, 2))
        iter_flows = []
        for _ in range(self.iters):
            hid, flow = self.update(hid, flow, pyramid, context, base)
            iter_flows.append(flow)
        up_full = self.ConvexUpsampler_0(hid.to(self.dtype), flow)
        seq = [8.0 * upsample_2d(f, h, w) for f in reversed(iter_flows)]
        return {"flows": [up_full] + seq}
