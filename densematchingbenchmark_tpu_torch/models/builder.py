"""Config-driven model builder.

Counterpart of densematchingbenchmark_tpu/models/builder.py:36-226: the
GeneralizedStereoModel branch (the backbone, aggregator and refinement
registries of PSMNet, AcfNet, StereoNet, GCNet and AnyNet, the confidence
network ``cmn`` of AcfNet adaptive, the fused upsample + soft-argmin
decision :119-136), the AnyNet branch (:183-203), the DeepPruner branch
(:204-226), and the compute dtype
(``model.dtype``, :31, :115) handed to every module. The configs' TPU
schedules keep the parameters of the plain modules and compute the same
function, and the port drops them here: ``pack`` (trunk D-packing,
StereoNet's, AnyNet's and DeepPruner's row-packed refinements), GCNet's
``phase_argmin`` (the head in phase layout, read by a phase soft-argmin:
the port reads the full-resolution cost with the disparity predictor,
K2), ``split_concat`` and ``w_pad``, and DeepPruner's PatchMatch
``scoring='corr'`` (its 'warp' scores by linearity). Of JAX's
backbones only PSMNet's takes a schedule field (``pack``): the others
take the config's keys as they are, so one with a schedule raises, as
in JAX. A name missing from a registry (a backbone, aggregator,
refinement or cost processor type) raises KeyError and an unknown
meta-architecture ValueError, as in JAX. Flax infers a first unit's
input channels at init; the port fixes them here, from the raw volume
the cost processor builds (``cost_processors.volume_planes``). A flow
config (``task`` "flow") builds through ``flow.models.build_flow_model``
(JAX :116-118), which raises ValueError for a meta-architecture it does
not register.

A ``mesh`` (parallel/mesh.make_mesh) reaches a GeneralizedStereoModel
only, where JAX's ``build_aggregator`` / ``build_cost_processor`` wire it
(:68-103): the cost processor gets ``cost_volume_sharding`` (each model
rank builds its planes of the raw volume), and the aggregators with a
``strided_sharding`` field in JAX (PSMNet, AcfNet, GCNet) get it and
``volume_sharding``. StereoNet's aggregator, which JAX leaves to XLA's
propagation of the raw volume's sharding, gets ``volume_sharding`` and
keeps D split through its stride-1 units. AnyNet, DeepPruner and the flow
models take no mesh, as in JAX: on a grid with several model ranks each
of them runs the whole model.
"""

import torch

from ..parallel.mesh import batch_only_volume_sharding, cost_volume_sharding
from .aggregators.acfnet import AcfAggregator
from .aggregators.gcnet import GCAggregator
from .aggregators.psmnet import PSMAggregator
from .aggregators.stereonet import StereoNetAggregator
from .anynet import AnyNet
from .backbones.anynet import AnyNetBackbone
from .backbones.deeppruner import (DeepPrunerBestBackbone,
                                   DeepPrunerFastBackbone)
from .backbones.gcnet import GCNetBackbone
from .backbones.psmnet import PSMNetBackbone
from .backbones.stereonet import StereoNetBackbone
from .cmn import Cmn
from .cost_processors import CostProcessor, volume_planes
from .deeppruner import DeepPruner
from .generalized import GeneralizedStereoModel
from .layers import init_parameters
from .predictors import build_disp_predictor
from .refinement.anynet import AnyNetRefinement
from .refinement.stereonet import StereoNetRefinement

BACKBONES = {"PSMNet": PSMNetBackbone, "GCNet": GCNetBackbone,
             "StereoNet": StereoNetBackbone, "AnyNet": AnyNetBackbone,
             "BestDeepPruner": DeepPrunerBestBackbone,
             "FastDeepPruner": DeepPrunerFastBackbone}
AGGREGATORS = {"PSMNet": PSMAggregator, "AcfNet": AcfAggregator,
               "GCNet": GCAggregator, "StereoNet": StereoNetAggregator}
# the backbones whose JAX counterparts take a schedule field
SCHEDULED_BACKBONES = {PSMNetBackbone}
REFINEMENTS = {"StereoNet": StereoNetRefinement,
               "AnyNet": AnyNetRefinement}
VOLUME_TYPES = {"Concatenation": "concatenation", "Difference": "difference",
                "Correlation": "correlation"}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# TPU schedules of the config sections (same parameters, same function)
_SCHEDULES = ("pack", "phase_argmin", "split_concat", "w_pad")


def _kwargs(cfg, drop=("in_planes",)):
    """A module's config section as its keyword arguments: without its
    type, its TPU schedules and ``drop`` (JAX drops in_planes for
    aggregators and refinements)."""
    return {k: v for k, v in cfg.items()
            if k not in ("type", *_SCHEDULES, *drop)}


def _backbone(model_cfg, dtype):
    bcfg = model_cfg["backbone"]
    cls = BACKBONES[bcfg["type"]]
    kwargs = (_kwargs(bcfg, drop=()) if cls in SCHEDULED_BACKBONES else
              {k: v for k, v in bcfg.items() if k != "type"})
    return cls(
        batch_norm=model_cfg.get("batch_norm", True), dtype=dtype, **kwargs)


def _anynet(model_cfg, dtype):
    """JAX builder.py:183-203."""
    comp = model_cfg["cost_processor"]["cost_computation"]
    agg = model_cfg["cost_processor"]["cost_aggregator"]
    bn = model_cfg.get("batch_norm", True)
    refinement = None
    if "disp_refinement" in model_cfg:
        refinement = AnyNetRefinement(
            spn_planes=model_cfg["disp_refinement"].get("spn_planes", 8),
            batch_norm=bn, dtype=dtype)
    return AnyNet(
        backbone=_backbone(model_cfg, dtype),
        disp_refinement=refinement,
        stage_max_disp=dict(comp["max_disp"]),
        stage_start_disp=dict(comp["start_disp"]),
        stage_dilation=dict(comp["dilation"]),
        stage_agg_planes=dict(agg["agg_planes"]),
        agg_num=agg.get("num", 4), batch_norm=bn, dtype=dtype)


def _deeppruner(model_cfg, dtype):
    """JAX builder.py:204-226."""
    sampler = model_cfg["disp_sampler"]
    proc = model_cfg["cost_processor"]
    return DeepPruner(
        backbone=_backbone(model_cfg, dtype),
        max_disp=model_cfg["max_disp"],
        scale=model_cfg.get("scale", 4),
        patch_match_sample_number=sampler.get(
            "patch_match_disparity_sample_number", 14),
        uniform_sample_number=sampler.get("uniform_disparity_sample_number",
                                          9),
        propagation_filter_size=sampler.get("propagation_filter_size", 3),
        iterations=sampler.get("iterations", 3),
        temperature=sampler.get("temperature", 7),
        hourglass_in_planes=proc.get("confidence_range_predictor", {}).get(
            "hourglass_in_planes", 16),
        refinement_num=model_cfg.get("disp_refinement", {}).get("num", 1),
        batch_norm=model_cfg.get("batch_norm", True), dtype=dtype)


_BRANCHES = {"AnyNet": _anynet, "DeepPruner": _deeppruner}


# the aggregators that take JAX's strided_sharding beside volume_sharding
_STRIDED = {PSMAggregator, AcfAggregator, GCAggregator}


def build_model(cfg, generator=None, mesh=None):
    """cfg (nested dict, see configs/) -> nn.Module, parameters initialised
    from ``generator`` (a torch.Generator; a fresh one seeded 0 if None);
    with ``mesh`` its cost volume split along D over the mesh's model
    axis (the same parameters)."""
    if cfg.get("task") == "flow":
        # lazy: flow.models imports models.layers
        from ..flow.models import build_flow_model
        return build_flow_model(cfg, generator)
    model_cfg = cfg["model"]
    name = model_cfg.get("dtype", "float32")
    if name not in DTYPES:
        raise ValueError(f"model.dtype={name!r}: one of {sorted(DTYPES)}")
    dtype = DTYPES[name]
    arch = model_cfg.get("meta_architecture", "GeneralizedStereoModel")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if arch in _BRANCHES:
        model = _BRANCHES[arch](model_cfg, dtype)
        init_parameters(model, generator)
        return model
    if arch != "GeneralizedStereoModel":
        raise ValueError(f"unknown meta architecture {arch}")
    bn = model_cfg.get("batch_norm", True)
    backbone = _backbone(model_cfg, dtype)
    cp = model_cfg["cost_processor"]
    agg = cp["cost_aggregator"]
    agg_cls = AGGREGATORS[agg["type"]]
    volume_type = VOLUME_TYPES[cp["type"]]
    refinement = None
    if "disp_refinement" in model_cfg:
        r = model_cfg["disp_refinement"]
        refinement = REFINEMENTS[r.get("type", "disp_refinement")](
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
    agg_kwargs = _kwargs(agg)
    if agg["type"] == "PSMNet":
        agg_kwargs["return_low_res"] = fused
    volume_sharding = None
    if mesh is not None:
        volume_sharding = agg_kwargs["volume_sharding"] = \
            cost_volume_sharding(mesh)
        if agg_cls in _STRIDED:
            agg_kwargs["strided_sharding"] = batch_only_volume_sharding(mesh)
    aggregator = agg_cls(
        in_planes=volume_planes(volume_type, backbone.out_planes),
        batch_norm=bn, dtype=dtype, **agg_kwargs)
    cmn = None
    if "cmn" in model_cfg:
        c = model_cfg["cmn"]
        cmn = Cmn(in_planes=c["in_planes"], num=c["num"], alpha=c["alpha"],
                  beta=c["beta"], batch_norm=bn, dtype=dtype)
    model = GeneralizedStereoModel(
        backbone=backbone,
        cost_processor=CostProcessor(
            aggregator, volume_type,
            max_disp=comp.get("max_disp", model_cfg["max_disp"]),
            start_disp=comp.get("start_disp", 0),
            dilation=comp.get("dilation", 1),
            normalize=comp.get("normalize", False), p=comp.get("p", 1.0),
            volume_sharding=volume_sharding),
        disp_predictor=build_disp_predictor(pred_cfg),
        cmn=cmn,
        disp_refinement=refinement,
        fused_upsample_argmin=fused,
        max_disp=model_cfg["max_disp"])
    init_parameters(model, generator)
    return model
