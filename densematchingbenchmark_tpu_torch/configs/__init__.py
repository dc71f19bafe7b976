"""Config zoo of the port: one module per model family, nested dicts with the
JAX package's field names (densematchingbenchmark_tpu/configs/).

Only the families ported so far are here. The compute dtype defaults to
float32 with no backend probe; this slice runs float32 only, so a ``_bf16``
name raises NotImplementedError (bf16 compute is queued in ROADMAP.md).
"""

from . import psmnet

CONFIGS = {
    "PSMNet/scene_flow": psmnet.scene_flow,
    "PSMNet/kitti_2015": psmnet.kitti_2015,
    "PSMNet/kitti_2012": psmnet.kitti_2012,
}


def get_config(name, **overrides):
    """Config dict for ``name`` (optionally ``<name>_f32``), with dotted-key
    overrides applied ({"model.max_disp": 64, ...})."""
    if name.endswith("_bf16"):
        raise NotImplementedError(
            f"{name}: bf16 compute is not ported yet (ROADMAP.md queue 1, "
            "bf16 compute); use the _f32 name")
    base = name[:-len("_f32")] if name.endswith("_f32") else name
    if base not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; the port has "
                       f"{sorted(CONFIGS)} (+ '_f32')")
    overrides.setdefault("model.dtype", "float32")
    return CONFIGS[base](**overrides)


__all__ = ["CONFIGS", "get_config"]
