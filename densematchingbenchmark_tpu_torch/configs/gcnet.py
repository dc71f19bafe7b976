"""GCNet configs (SceneFlow, KITTI 2015 and 2012): the concatenation
volume at half resolution, 96 disparities there, the 3-D encoder-decoder
and its full-resolution head, 192 disparities.

Counterpart of densematchingbenchmark_tpu/configs/gcnet.py, kept as this
package's own copy with the same field names and values. The aggregator's
``pack`` and ``phase_argmin`` are TPU schedules with the same parameters,
which the port reads but does not act on (models/builder.py drops them).
"""

import copy

from .psmnet import _BASE, _apply_overrides


def _base():
    cfg = copy.deepcopy(_BASE)
    cfg["model"].update(
        backbone=dict(type="GCNet", in_planes=3),
        cost_processor=dict(
            type="Concatenation",
            cost_computation=dict(max_disp=96, start_disp=0, dilation=1),
            cost_aggregator=dict(type="GCNet", max_disp=192, in_planes=64,
                                 pack=2, phase_argmin=True),
        ),
        losses=dict(
            l1_loss=dict(max_disp=192, weights=(1.0,), weight=1.0),
        ),
    )
    cfg["data"]["batch_size_per_device"] = 1
    return cfg


def scene_flow(**overrides):
    return _apply_overrides(_base(), overrides)


def _kitti(dataset_type):
    cfg = _base()
    cfg["data"].update(type=dataset_type, sparse=True)
    cfg["data"]["eval"]["input_shape"] = (384, 1248)
    cfg["data"]["test"]["input_shape"] = (384, 1248)
    return cfg


def kitti_2015(**overrides):
    return _apply_overrides(_kitti("KITTI-2015"), overrides)


def kitti_2012(**overrides):
    """KITTI-2012 variant (the JAX package's own; the reference ships no
    config for it)."""
    return _apply_overrides(_kitti("KITTI-2012"), overrides)
