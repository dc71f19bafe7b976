"""Config-driven model builder.

Counterpart of densematchingbenchmark_tpu/models/builder.py:106-182, the
GeneralizedStereoModel branch with a PSMNet backbone, a PSMNet or AcfNet
aggregator and the optional confidence network (``cmn``, AcfNet
adaptive), including the fused upsample + soft-argmin decision (:119-136),
and the compute dtype (``model.dtype``, :31, :115) handed to the backbone,
the aggregator and the cmn. Families not ported yet raise
NotImplementedError naming their ROADMAP.md item.
"""

import torch

from .aggregators.acfnet import AcfAggregator
from .aggregators.psmnet import PSMAggregator
from .backbones.psmnet import PSMNetBackbone
from .cmn import Cmn
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
    "flow": "queue 1 item 11 (Flow)",
}


def _not_ported(what):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md "
        f"{_NOT_PORTED.get(what, 'queue 1')})")


VOLUME_TYPES = {"Concatenation": "concatenation"}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_model(cfg, generator=None):
    """cfg (nested dict, see configs/) -> nn.Module, parameters initialised
    from ``generator`` (a torch.Generator; a fresh one seeded 0 if None)."""
    model_cfg = cfg["model"]
    name = model_cfg.get("dtype", "float32")
    if name not in DTYPES:
        raise ValueError(f"model.dtype={name!r}: one of {sorted(DTYPES)}")
    dtype = DTYPES[name]
    if cfg.get("task") == "flow":
        _not_ported("flow")
    arch = model_cfg.get("meta_architecture", "GeneralizedStereoModel")
    if arch != "GeneralizedStereoModel":
        _not_ported(arch)
    if "disp_refinement" in model_cfg:
        _not_ported(model_cfg["disp_refinement"].get("type",
                                                     "disp_refinement"))
    bn = model_cfg.get("batch_norm", True)
    bcfg = model_cfg["backbone"]
    if bcfg["type"] != "PSMNet":
        _not_ported(bcfg["type"])
    cp = model_cfg["cost_processor"]
    agg = cp["cost_aggregator"]
    if agg["type"] not in ("PSMNet", "AcfNet"):
        _not_ported(agg["type"])
    if cp["type"] not in VOLUME_TYPES:
        raise NotImplementedError(
            f"{cp['type']} cost processor is not ported yet (ROADMAP.md "
            "queue 1)")
    pred_cfg = model_cfg["disp_predictor"]
    # fuse upsample + soft-argmin at eval only when nothing else needs the
    # full-resolution cost volume (no cmn) and the aggregator can return
    # the low-resolution costs (PSMNet's): the JAX builder's rule
    fused = bool(model_cfg.get("eval", {}).get("fused_upsample_argmin",
                                               False)
                 and "cmn" not in model_cfg and agg["type"] == "PSMNet"
                 and pred_cfg["type"] in ("FASTER", "DEFAULT"))

    comp = cp.get("cost_computation", {})
    # the configs' ``pack`` fields are TPU schedules with the same
    # parameters as the unpacked modules; the port has one schedule
    backbone = PSMNetBackbone(in_planes=bcfg.get("in_planes", 3),
                              batch_norm=bn, dtype=dtype)
    if agg["type"] == "AcfNet":
        aggregator = AcfAggregator(in_planes=64,
                                   max_disp=agg.get("max_disp", 192),
                                   batch_norm=bn, dtype=dtype)
    else:
        aggregator = PSMAggregator(
            in_planes=64, max_disp=agg.get("max_disp", 192), batch_norm=bn,
            return_low_res=fused, dtype=dtype)
    cmn = None
    if "cmn" in model_cfg:
        c = model_cfg["cmn"]
        cmn = Cmn(in_planes=c["in_planes"], num=c["num"], alpha=c["alpha"],
                  beta=c["beta"], batch_norm=bn, dtype=dtype)
    model = GeneralizedStereoModel(
        backbone=backbone,
        cost_processor=CostProcessor(
            aggregator, VOLUME_TYPES[cp["type"]],
            max_disp=comp.get("max_disp", model_cfg["max_disp"]),
            start_disp=comp.get("start_disp", 0),
            dilation=comp.get("dilation", 1)),
        disp_predictor=build_disp_predictor(pred_cfg),
        cmn=cmn,
        fused_upsample_argmin=fused,
        max_disp=model_cfg["max_disp"])
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_parameters(model, generator)
    return model
