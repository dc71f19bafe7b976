"""Config-driven model builder.

Counterpart of densematchingbenchmark_tpu/models/builder.py:36-182, the
GeneralizedStereoModel branch: the backbone, aggregator and refinement
registries of the families ported so far (PSMNet, AcfNet, StereoNet), the
confidence network (``cmn``, AcfNet adaptive), the fused upsample +
soft-argmin decision (:119-136), and the compute dtype (``model.dtype``,
:31, :115) handed to every module. The configs' ``pack`` fields are TPU
schedules with the same parameters as the unpacked modules (trunk
D-packing, StereoNet's row-packed refinement): the port has one schedule
and drops them here. Families not ported yet raise
NotImplementedError naming their ROADMAP.md item.
"""

import torch

from .aggregators.acfnet import AcfAggregator
from .aggregators.psmnet import PSMAggregator
from .aggregators.stereonet import StereoNetAggregator
from .backbones.psmnet import PSMNetBackbone
from .backbones.stereonet import StereoNetBackbone
from .cmn import Cmn
from .cost_processors import CostProcessor
from .generalized import GeneralizedStereoModel
from .layers import init_parameters
from .predictors import build_disp_predictor
from .refinement.stereonet import StereoNetRefinement

_NOT_PORTED = {
    "AnyNet": "queue 1 item 10 (AnyNet)",
    "DeepPruner": "queue 1 item 9 (DeepPruner)",
    "BestDeepPruner": "queue 1 item 9 (DeepPruner)",
    "FastDeepPruner": "queue 1 item 9 (DeepPruner)",
    "GCNet": "queue 1 item 8 (GCNet)",
    "flow": "queue 1 item 11 (Flow)",
}


def _not_ported(what):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md "
        f"{_NOT_PORTED.get(what, 'queue 1')})")


BACKBONES = {"PSMNet": PSMNetBackbone, "StereoNet": StereoNetBackbone}
AGGREGATORS = {"PSMNet": PSMAggregator, "AcfNet": AcfAggregator,
               "StereoNet": StereoNetAggregator}
REFINEMENTS = {"StereoNet": StereoNetRefinement}
VOLUME_TYPES = {"Concatenation": "concatenation", "Difference": "difference"}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _lookup(registry, what):
    if what not in registry:
        _not_ported(what)
    return registry[what]


def _kwargs(cfg, drop=("in_planes",)):
    """A module's config section as its keyword arguments: without its
    type, its ``pack`` (a TPU schedule) and ``drop`` (JAX drops in_planes
    for aggregators and refinements)."""
    return {k: v for k, v in cfg.items()
            if k not in ("type", "pack", *drop)}


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
    bn = model_cfg.get("batch_norm", True)
    bcfg = model_cfg["backbone"]
    backbone_cls = _lookup(BACKBONES, bcfg["type"])
    cp = model_cfg["cost_processor"]
    agg = cp["cost_aggregator"]
    agg_cls = _lookup(AGGREGATORS, agg["type"])
    if cp["type"] not in VOLUME_TYPES:
        raise NotImplementedError(
            f"{cp['type']} cost processor is not ported yet (ROADMAP.md "
            "queue 1)")
    refinement = None
    if "disp_refinement" in model_cfg:
        r = model_cfg["disp_refinement"]
        refinement = _lookup(REFINEMENTS, r.get("type", "disp_refinement"))(
            batch_norm=bn, dtype=dtype, **_kwargs(r))
    pred_cfg = model_cfg["disp_predictor"]
    # fuse upsample + soft-argmin at eval only when nothing else needs the
    # full-resolution cost volume (no cmn) and the aggregator can return
    # the low-resolution costs (PSMNet's): the JAX builder's rule
    fused = bool(model_cfg.get("eval", {}).get("fused_upsample_argmin",
                                               False)
                 and "cmn" not in model_cfg and agg["type"] == "PSMNet"
                 and pred_cfg["type"] in ("FASTER", "DEFAULT"))

    comp = cp.get("cost_computation", {})
    backbone = backbone_cls(batch_norm=bn, dtype=dtype,
                            **_kwargs(bcfg, drop=()))
    agg_kwargs = _kwargs(agg)
    if agg["type"] == "PSMNet":
        agg_kwargs["return_low_res"] = fused
    aggregator = agg_cls(batch_norm=bn, dtype=dtype, **agg_kwargs)
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
            dilation=comp.get("dilation", 1),
            normalize=comp.get("normalize", False), p=comp.get("p", 1.0)),
        disp_predictor=build_disp_predictor(pred_cfg),
        cmn=cmn,
        disp_refinement=refinement,
        fused_upsample_argmin=fused,
        max_disp=model_cfg["max_disp"])
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_parameters(model, generator)
    return model
