"""PWCFlow, the coarse-to-fine correlation flow model, and the flow
model registry.

Counterpart of densematchingbenchmark_tpu/flow/models.py:31-175: a
siamese conv pyramid (level i at stride 2^(i + 1)), then from the
coarsest level to the finest the target features warped backward by the
upsampled coarser flow (``ops/warp.flow_warp``), a local 2-D correlation
(``ops/cost_volume.correlation2d_volume``, leaky ReLU 0.1), three 2-D
units scoring the (2 radius + 1)^2 displacements and a float32
soft-argmax over them (``ops/soft_argmin.soft_argmax_2d``) as the
residual flow; a dilated context refinement at the finest level, and the
refined flow upsampled to the input's resolution. Every convolution is a
2-D ``ConvUnit`` on the library; the flow path launches none of the
port's hand-written kernels (JAX's reaches no Pallas kernel).

Modules take and return [B, H, W, C] maps. Submodule names follow the
Flax tree: ``FlowPyramidEncoder_0`` (called on both frames: its BN's
running statistics move twice in a training step, in that order, as
Flax's), ``FlowEstimator_<i>`` from the coarsest level, and
``ContextRefinement_0``. In bfloat16 the warp takes the flow cast to the
features' dtype, the soft-argmax and every flow stay float32, as JAX's.
"""

import torch
from torch import nn

from ..models.layers import ConvUnit, init_parameters
from ..ops.cost_volume import correlation2d_volume
from ..ops.interpolate import upsample_2d
from ..ops.soft_argmin import soft_argmax_2d
from ..ops.warp import flow_warp

def _units(module, units):
    """Register ``units`` as ConvUnit_0, ConvUnit_1, ... of ``module``."""
    for i, unit in enumerate(units):
        setattr(module, f"ConvUnit_{i}", unit)
    return tuple(units)


class FlowPyramidEncoder(nn.Module):
    """Per level a stride-2 and a stride-1 3x3 unit with BN and ReLU;
    returns each level's map, finest first."""

    def __init__(self, chans=(16, 32, 64, 96), batch_norm=True,
                 dtype=torch.float32):
        super().__init__()
        units, cin = [], 3
        for c in chans:
            units += [ConvUnit(cin, c, 3, 2, 1, batch_norm=batch_norm,
                               dtype=dtype),
                      ConvUnit(c, c, 3, 1, 1, batch_norm=batch_norm,
                               dtype=dtype)]
            cin = c
        self.units = _units(self, units)

    def forward(self, x):
        feats = []
        for down, unit in zip(self.units[::2], self.units[1::2]):
            x = unit(down(x))
            feats.append(x)
        return feats


class FlowEstimator(nn.Module):
    """Residual flow of one level: [corr | features | upsampled flow] ->
    two units -> scores over the displacement window -> soft-argmax."""

    def __init__(self, in_features, radius, hidden=96, batch_norm=True,
                 dtype=torch.float32):
        super().__init__()
        self.radius = radius
        n = (2 * radius + 1) ** 2
        _units(self, [
            ConvUnit(in_features, hidden, batch_norm=batch_norm,
                     dtype=dtype),
            ConvUnit(hidden, hidden, batch_norm=batch_norm, dtype=dtype),
            ConvUnit(hidden, n, batch_norm=False, relu=False, dtype=dtype)])

    def forward(self, corr, ref_fm, up_flow):
        x = torch.cat([corr, ref_fm, up_flow.to(corr.dtype)], dim=-1)
        scores = self.ConvUnit_2(self.ConvUnit_1(self.ConvUnit_0(x)))
        return up_flow + soft_argmax_2d(scores, self.radius)


class ContextRefinement(nn.Module):
    """Dilated residual refinement of the finest level's flow on
    [features | flow]."""

    def __init__(self, in_features, hidden=64, dilations=(1, 2, 4, 8, 1),
                 batch_norm=True, dtype=torch.float32):
        super().__init__()
        units, cin = [], in_features
        for d in dilations:
            units.append(ConvUnit(cin, hidden, padding=d, dilation=d,
                                  batch_norm=batch_norm, dtype=dtype))
            cin = hidden
        units.append(ConvUnit(hidden, 2, batch_norm=False, relu=False,
                              dtype=dtype))
        self.units = _units(self, units)

    def forward(self, fm, flow):
        x = torch.cat([fm, flow.to(fm.dtype)], dim=-1)
        for unit in self.units:
            x = unit(x)
        return flow + x.float()


class PWCFlow(nn.Module):
    """forward(ref, tgt) with [B, H, W, 3] frames -> {'flows': [B, h, w, 2]
    float32 fields, best first}: the refined flow at the input's
    resolution, then each pyramid level's, fine to coarse."""

    def __init__(self, chans=(16, 32, 64, 96), radius=4, hidden=96,
                 batch_norm=True, dtype=torch.float32):
        super().__init__()
        self.chans, self.radius, self.dtype = tuple(chans), radius, dtype
        self.FlowPyramidEncoder_0 = FlowPyramidEncoder(chans, batch_norm,
                                                       dtype)
        n = (2 * radius + 1) ** 2
        self.FlowEstimator = nn.ModuleList(
            FlowEstimator(n + c + 2, radius, hidden, batch_norm, dtype)
            for c in reversed(self.chans))
        self.ContextRefinement_0 = ContextRefinement(
            self.chans[0] + 2, batch_norm=batch_norm, dtype=dtype)

    def forward(self, ref_img, tgt_img):
        b, h, w, _ = ref_img.shape
        encoder = self.FlowPyramidEncoder_0
        ref_feats = encoder(ref_img.to(self.dtype))
        tgt_feats = encoder(tgt_img.to(self.dtype))
        flows, flow = [], None          # coarse -> fine during the loop
        for estimator, lvl in zip(self.FlowEstimator,
                                  reversed(range(len(self.chans)))):
            ref_fm, tgt_fm = ref_feats[lvl], tgt_feats[lvl]
            lh, lw = ref_fm.shape[1:3]
            if flow is None:
                up_flow = ref_fm.new_zeros((b, lh, lw, 2), dtype=torch.float32)
            else:
                up_flow = 2.0 * upsample_2d(flow, lh, lw)
            warped = flow_warp(tgt_fm, up_flow.to(tgt_fm.dtype))
            corr = correlation2d_volume(ref_fm, warped, self.radius)
            corr = nn.functional.leaky_relu(corr, 0.1)
            flow = estimator(corr, ref_fm, up_flow)
            flows.append(flow)
        flow = self.ContextRefinement_0(ref_feats[0], flow)
        full = 2.0 * upsample_2d(flow, h, w)    # the finest level's stride
        return {"flows": [full] + flows[::-1]}


def _dtype(m):
    from ..models.builder import DTYPES
    name = m.get("dtype", "float32")
    if name not in DTYPES:
        raise ValueError(f"model.dtype={name!r}: one of {sorted(DTYPES)}")
    return DTYPES[name]


def _build_pwcflow(cfg):
    m = cfg["model"]
    return PWCFlow(chans=tuple(m.get("chans", (16, 32, 64, 96))),
                   radius=m.get("radius", 4), hidden=m.get("hidden", 96),
                   batch_norm=m.get("batch_norm", True), dtype=_dtype(m))


def _build_raft(cfg):
    from .raft import RAFTFlow
    m = cfg["model"]
    return RAFTFlow(iters=m.get("iters", 8), radius=m.get("radius", 3),
                    levels=m.get("levels", 4), hidden=m.get("hidden", 96),
                    context=m.get("context", 64),
                    batch_norm=m.get("batch_norm", True), dtype=_dtype(m))


FLOW_META_ARCHITECTURES = {
    "PWCFlow": _build_pwcflow,
    "RAFTFlow": _build_raft,
}


def build_flow_model(cfg, generator=None):
    """cfg -> the flow nn.Module of model.meta_architecture, parameters
    initialised from ``generator`` (a fresh one seeded 0 if None) with
    the JAX package's initialisers (models/layers.init_parameters)."""
    arch = cfg["model"].get("meta_architecture")
    if arch not in FLOW_META_ARCHITECTURES:
        raise ValueError(
            f"no flow meta-architecture registered for '{arch}' "
            f"(available: {sorted(FLOW_META_ARCHITECTURES)})")
    model = FLOW_META_ARCHITECTURES[arch](cfg)
    init_parameters(model, generator if generator is not None
                    else torch.Generator().manual_seed(0))
    return model
