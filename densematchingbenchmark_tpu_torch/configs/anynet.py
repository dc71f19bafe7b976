"""AnyNet config (SceneFlow: C = 1, three stages, a residual range of 5
samples from -2 at 1/8 and 1/4, the SPN refinement, lr 5e-4).

Counterpart of densematchingbenchmark_tpu/configs/anynet.py, kept as this
package's own copy with the same field names and values.
"""

import copy

from .psmnet import _BASE, _apply_overrides


def scene_flow(**overrides):
    cfg = copy.deepcopy(_BASE)
    cfg["model"] = dict(
        meta_architecture="AnyNet",
        max_disp=192,
        batch_norm=True,
        dtype="float32",
        stage=("init_guess", "warp_level_8", "warp_level_4"),
        backbone=dict(type="AnyNet", in_planes=3, C=1, block_num=2),
        cost_processor=dict(
            type="AnyNet",
            cost_computation=dict(
                max_disp=dict(init_guess=12, warp_level_8=5, warp_level_4=5),
                start_disp=dict(init_guess=0, warp_level_8=-2,
                                warp_level_4=-2),
                dilation=dict(init_guess=1, warp_level_8=1, warp_level_4=1),
            ),
            cost_aggregator=dict(
                type="AnyNet",
                agg_planes=dict(init_guess=16, warp_level_8=4,
                                warp_level_4=4),
                num=4,
            ),
        ),
        disp_refinement=dict(type="AnyNet", spn_planes=8),
        losses=dict(
            l1_loss=dict(max_disp=192, weights=(1.0, 1.0, 0.5, 0.25),
                         weight=1.0),
        ),
        eval=dict(lower_bound=0, upper_bound=192, eval_occlusion=True,
                  batch_size=4),
    )
    cfg["data"]["batch_size_per_device"] = 6
    cfg["optimizer"]["lr"] = 5e-4
    cfg["total_epochs"] = 20
    cfg["eval_disparity_id"] = (0, 1, 2, 3)
    return _apply_overrides(cfg, overrides)
