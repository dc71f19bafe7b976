"""AcfNet configs (uniform / adaptive; SceneFlow, KITTI-2015, KITTI-2012).

Counterpart of densematchingbenchmark_tpu/configs/acfnet.py, kept as this
package's own copy: the PSMNet base with the AcfNet aggregator (the PSMNet
trunk, learned 4x transposed-conv upsampling), the stereo focal loss beside
the smooth-L1 loss, and in the adaptive configs the confidence network
(``cmn``: per-pixel focal-loss variance from confidence, and its NLL loss).
The ``pack`` fields are TPU schedules that the port reads but does not act
on, as in configs/psmnet.py.
"""

import copy

from .psmnet import _BASE, _apply_overrides


def _base(adaptive):
    cfg = copy.deepcopy(_BASE)
    cfg["model"].update(
        backbone=dict(type="PSMNet", in_planes=3, pack=4),
        cost_processor=dict(
            type="Concatenation",
            cost_computation=dict(max_disp=48, start_disp=0, dilation=1),
            cost_aggregator=dict(type="AcfNet", max_disp=192, in_planes=64,
                                 pack=4),
        ),
        losses=dict(
            l1_loss=dict(max_disp=192, weights=(1.0, 0.7, 0.5), weight=0.1),
            focal_loss=dict(max_disp=192, start_disp=0, dilation=1,
                            weights=(1.0, 0.7, 0.5), coefficient=5.0,
                            weight=1.0,
                            variance=None if adaptive else 1.2),
        ),
    )
    if adaptive:
        cfg["model"]["cmn"] = dict(
            num=3, alpha=1.0, beta=1.0, in_planes=192,
            losses=dict(nll_loss=dict(max_disp=192, start_disp=0,
                                      weight=8.0,
                                      weights=(1.0, 0.7, 0.5))))
    return cfg


def scene_flow_uniform(**overrides):
    return _apply_overrides(_base(False), overrides)


def scene_flow_adaptive(**overrides):
    return _apply_overrides(_base(True), overrides)


def _kitti(cfg, dataset_type="KITTI-2015"):
    cfg["data"].update(type=dataset_type, sparse=True)
    cfg["data"]["eval"]["input_shape"] = (384, 1248)
    cfg["data"]["test"]["input_shape"] = (384, 1248)
    return cfg


def kitti_2015_uniform(**overrides):
    return _apply_overrides(_kitti(_base(False)), overrides)


def kitti_2015_adaptive(**overrides):
    return _apply_overrides(_kitti(_base(True)), overrides)


def kitti_2012_uniform(**overrides):
    return _apply_overrides(_kitti(_base(False), "KITTI-2012"), overrides)


def kitti_2012_adaptive(**overrides):
    return _apply_overrides(_kitti(_base(True), "KITTI-2012"), overrides)
