"""StereoNet configs (SceneFlow, 8x: the difference volume at 1/8, 24 cost
disparities; 2-stage: one edge-aware refinement, 4-stage: three).

Counterpart of densematchingbenchmark_tpu/configs/stereonet.py, kept as
this package's own copy with the same field names and values. The
``pack`` fields are TPU schedules that the port reads but does not act on
(models/builder.py drops them).
"""

import copy

from .psmnet import _BASE, _apply_overrides


def _base(refine_num=1):
    cfg = copy.deepcopy(_BASE)
    cfg["model"].update(
        backbone=dict(type="StereoNet", in_planes=3, downsample_num=3,
                      residual_num=6),
        cost_processor=dict(
            type="Difference",
            cost_computation=dict(max_disp=24, start_disp=0, dilation=1),
            cost_aggregator=dict(type="StereoNet", max_disp=192, num=4,
                                 pack=4),
        ),
        disp_predictor=dict(type="FASTER", max_disp=24, start_disp=0,
                            dilation=1, alpha=1.0, normalize=True),
        disp_refinement=dict(type="StereoNet", num=refine_num, pack=4),
        losses=dict(
            # weights (1.0, 0.5[, ...]) over [refined..., initial]
            l1_loss=dict(max_disp=192,
                         weights=tuple([1.0] + [0.5] * refine_num),
                         weight=1.0),
        ),
    )
    cfg["data"]["batch_size_per_device"] = 4
    cfg["lr_schedule"]["step"] = (11,)
    cfg["total_epochs"] = 11
    cfg["eval_disparity_id"] = (0, 1)
    return cfg


def scene_flow_8x_2stage(**overrides):
    return _apply_overrides(_base(1), overrides)


def scene_flow_8x_4stage(**overrides):
    cfg = _base(3)
    cfg["eval_disparity_id"] = (0, 1, 2, 3)
    return _apply_overrides(cfg, overrides)
