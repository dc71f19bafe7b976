"""DeepPruner configs (Best = 4x, Fast = 8x, SceneFlow).

Counterpart of densematchingbenchmark_tpu/configs/deeppruner.py, kept as
this package's own copy with the same field names and values. Three
fields are TPU schedules with the same parameters and the same function,
which the port reads but does not act on (models/builder.py drops them):
the disparity sampler's ``scoring='corr'`` (PatchMatch's scores from an
integer-shift correlation volume contracted with static tent windows; the
port warps the features, ``'warp'``) and the refinement's ``pack``.
"""

import copy

from .psmnet import _BASE, _apply_overrides


def _base(scale):
    cfg = copy.deepcopy(_BASE)
    cfg["model"] = dict(
        meta_architecture="DeepPruner",
        max_disp=192,
        batch_norm=True,
        dtype="float32",
        scale=scale,
        backbone=dict(
            type="BestDeepPruner" if scale == 4 else "FastDeepPruner",
            in_planes=3),
        disp_sampler=dict(
            type="DeepPruner",
            max_disp=192 // scale,
            propagation_filter_size=3,
            iterations=3,
            temperature=7,
            patch_match_disparity_sample_number=14,
            uniform_disparity_sample_number=9,
            scoring="corr",
        ),
        cost_processor=dict(
            type="DeepPruner",
            patch_match_disparity_sample_number=14,
            uniform_disparity_sample_number=9,
            confidence_range_predictor=dict(hourglass_in_planes=16),
            cost_aggregator=dict(type="DeepPruner",
                                 hourglass_in_planes=16),
        ),
        disp_refinement=dict(type="DeepPruner",
                             num=1 if scale == 4 else 2, pack=4),
        losses=dict(
            l1_loss=dict(max_disp=192, weights=(1.3, 1.0, 0.7, 0.7),
                         weight=1.0),
            quantile_loss=dict(max_disp=192, weight=1.0, theta=0.05),
        ),
        eval=dict(lower_bound=0, upper_bound=192, eval_occlusion=True,
                  batch_size=4),
    )
    if scale == 8:
        # Fast: refined (1/4 -> 1/2), refined (1/2 -> 1), post disparity,
        # min, max
        cfg["model"]["losses"]["l1_loss"]["weights"] = (1.6, 1.3, 1.0, 0.7,
                                                        0.7)
    cfg["data"]["batch_size_per_device"] = 5
    cfg["total_epochs"] = 64
    cfg["lr_schedule"]["step"] = (20, 40, 60)
    cfg["eval_disparity_id"] = (0, 1)
    return cfg


def scene_flow_4x(**overrides):
    return _apply_overrides(_base(4), overrides)


def scene_flow_8x(**overrides):
    return _apply_overrides(_base(8), overrides)
