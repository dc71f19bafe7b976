"""Config-driven model builder.

Counterpart of densematchingbenchmark_tpu/models/builder.py:106-182, the
GeneralizedStereoModel branch with a PSMNet backbone and aggregator,
including the fused upsample + soft-argmin decision (:119-136). Families not
ported yet raise NotImplementedError naming their ROADMAP.md item.
"""

import torch

from .aggregators.psmnet import PSMAggregator
from .backbones.psmnet import PSMNetBackbone
from .cost_processors import CostProcessor
from .generalized import GeneralizedStereoModel
from .layers import init_parameters
from .predictors import build_disp_predictor

_NOT_PORTED = {
    "AnyNet": "queue 1 item 10 (AnyNet)",
    "DeepPruner": "queue 1 item 9 (DeepPruner)",
    "BestDeepPruner": "queue 1 item 9 (DeepPruner)",
    "FastDeepPruner": "queue 1 item 9 (DeepPruner)",
    "GCNet": "queue 1 item 8 (GCNet)",
    "StereoNet": "queue 1 item 7 (StereoNet)",
    "AcfNet": "queue 1 item 6 (AcfNet)",
    "cmn": "queue 1 item 6 (AcfNet)",
    "flow": "queue 1 item 11 (Flow)",
}


def _not_ported(what):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md "
        f"{_NOT_PORTED.get(what, 'queue 1')})")


VOLUME_TYPES = {"Concatenation": "concatenation"}


def build_model(cfg, generator=None):
    """cfg (nested dict, see configs/) -> nn.Module, parameters initialised
    from ``generator`` (a torch.Generator; a fresh one seeded 0 if None)."""
    model_cfg = cfg["model"]
    if model_cfg.get("dtype", "float32") != "float32":
        raise NotImplementedError(
            f"model.dtype={model_cfg['dtype']!r}: this port runs float32 "
            "only so far (ROADMAP.md queue 1, bf16 compute)")
    if cfg.get("task") == "flow":
        _not_ported("flow")
    arch = model_cfg.get("meta_architecture", "GeneralizedStereoModel")
    if arch != "GeneralizedStereoModel":
        _not_ported(arch)
    for key in ("cmn", "disp_refinement"):
        if key in model_cfg:
            _not_ported("cmn" if key == "cmn"
                        else model_cfg[key].get("type", key))
    bn = model_cfg.get("batch_norm", True)
    bcfg = model_cfg["backbone"]
    if bcfg["type"] != "PSMNet":
        _not_ported(bcfg["type"])
    cp = model_cfg["cost_processor"]
    agg = cp["cost_aggregator"]
    if agg["type"] != "PSMNet":
        _not_ported(agg["type"])
    if cp["type"] not in VOLUME_TYPES:
        raise NotImplementedError(
            f"{cp['type']} cost processor is not ported yet (ROADMAP.md "
            "queue 1)")
    pred_cfg = model_cfg["disp_predictor"]
    # fuse upsample + soft-argmin at eval only when nothing else needs the
    # full-resolution cost volume (same rule as the JAX builder)
    fused = bool(model_cfg.get("eval", {}).get("fused_upsample_argmin",
                                               False)
                 and pred_cfg["type"] in ("FASTER", "DEFAULT"))

    comp = cp.get("cost_computation", {})
    # the configs' ``pack`` fields are TPU schedules with the same
    # parameters as the unpacked modules; the port has one schedule
    backbone = PSMNetBackbone(in_planes=bcfg.get("in_planes", 3),
                              batch_norm=bn)
    aggregator = PSMAggregator(
        in_planes=64, max_disp=agg.get("max_disp", 192), batch_norm=bn,
        return_low_res=fused)
    model = GeneralizedStereoModel(
        backbone=backbone,
        cost_processor=CostProcessor(
            aggregator, VOLUME_TYPES[cp["type"]],
            max_disp=comp.get("max_disp", model_cfg["max_disp"]),
            start_disp=comp.get("start_disp", 0),
            dilation=comp.get("dilation", 1)),
        disp_predictor=build_disp_predictor(pred_cfg),
        fused_upsample_argmin=fused,
        max_disp=model_cfg["max_disp"])
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_parameters(model, generator)
    return model
