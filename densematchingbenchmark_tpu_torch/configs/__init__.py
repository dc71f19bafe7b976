"""Config zoo of the port: one module per model family, nested dicts with the
JAX package's field names (densematchingbenchmark_tpu/configs/).

Only the families ported so far are here. As in the JAX package
(configs/__init__.py:40-103), ``<name>_bf16`` pins bfloat16 compute
(float32 parameters and BN statistics, bfloat16 activations and
convolutions, a float32 soft-argmin), ``<name>_f32`` pins float32, and a
name without a suffix takes ``default_compute_dtype()``.
"""

import os

import torch

from . import acfnet, anynet, deeppruner, gcnet, psmnet, pwcflow, stereonet

_FAMILIES = {
    "PSMNet/scene_flow": psmnet.scene_flow,
    "PSMNet/kitti_2015": psmnet.kitti_2015,
    "PSMNet/kitti_2012": psmnet.kitti_2012,
    "AcfNet/scene_flow_uniform": acfnet.scene_flow_uniform,
    "AcfNet/scene_flow_adaptive": acfnet.scene_flow_adaptive,
    "AcfNet/kitti_2015_uniform": acfnet.kitti_2015_uniform,
    "AcfNet/kitti_2015_adaptive": acfnet.kitti_2015_adaptive,
    "AcfNet/kitti_2012_uniform": acfnet.kitti_2012_uniform,
    "AcfNet/kitti_2012_adaptive": acfnet.kitti_2012_adaptive,
    "StereoNet/scene_flow_8x_2stage": stereonet.scene_flow_8x_2stage,
    "StereoNet/scene_flow_8x_4stage": stereonet.scene_flow_8x_4stage,
    "GCNet/scene_flow": gcnet.scene_flow,
    "GCNet/kitti_2015": gcnet.kitti_2015,
    "GCNet/kitti_2012": gcnet.kitti_2012,
    "DeepPruner/scene_flow_4x": deeppruner.scene_flow_4x,
    "DeepPruner/scene_flow_8x": deeppruner.scene_flow_8x,
    "AnyNet/scene_flow": anynet.scene_flow,
    "PWCFlow/flying_chairs": pwcflow.flying_chairs,
    "RAFT/flying_chairs": pwcflow.raft_flying_chairs,
}
_SUFFIXES = {"_bf16": "bfloat16", "_f32": "float32"}


def _dtype_variant(factory, dtype):
    def f(**overrides):
        overrides.setdefault("model.dtype", dtype)
        return factory(**overrides)
    return f


CONFIGS = dict(_FAMILIES)
CONFIGS.update({name + suffix: _dtype_variant(fn, dtype)
                for suffix, dtype in _SUFFIXES.items()
                for name, fn in _FAMILIES.items()})


def default_compute_dtype():
    """The compute dtype of a config name without a suffix: the
    ``DMB_DEFAULT_DTYPE`` environment variable when it is set, else
    "bfloat16" on a machine with a CUDA device and "float32" without one
    (JAX's rule: bfloat16 on an accelerator, float32 on the CPU). It asks
    the driver for a device count and creates no CUDA context."""
    env = os.environ.get("DMB_DEFAULT_DTYPE")
    if env:
        return env
    return "bfloat16" if torch.cuda.is_available() else "float32"


def get_config(name, **overrides):
    """Config dict for ``name`` (``<name>``, ``<name>_bf16`` or
    ``<name>_f32``), with dotted-key overrides applied ({"model.max_disp":
    64, ...}); an explicit ``model.dtype`` override wins over the name."""
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; the port has "
                       f"{sorted(_FAMILIES)} (+ '_bf16', '_f32')")
    if name in _FAMILIES:
        overrides.setdefault("model.dtype", default_compute_dtype())
    return CONFIGS[name](**overrides)


__all__ = ["CONFIGS", "default_compute_dtype", "get_config"]
