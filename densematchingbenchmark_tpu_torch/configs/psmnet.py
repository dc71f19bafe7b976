"""PSMNet configs (SceneFlow / KITTI-2015 / KITTI-2012).

Counterpart of densematchingbenchmark_tpu/configs/psmnet.py, kept as this
package's own copy. Field names and values are the same, so a config built
here and one built there describe the same model; the ``pack`` fields are
TPU schedules that this port reads but does not act on (the parameter trees
are identical for every pack value).
"""

import copy

_BASE = dict(
    task="stereo",
    model=dict(
        meta_architecture="GeneralizedStereoModel",
        max_disp=192,
        batch_norm=True,
        dtype="float32",
        backbone=dict(type="PSMNet", in_planes=3, pack=4),
        cost_processor=dict(
            type="Concatenation",
            cost_computation=dict(max_disp=48, start_disp=0, dilation=1),
            cost_aggregator=dict(type="PSMNet", max_disp=192, pack=4),
        ),
        disp_predictor=dict(type="FASTER", max_disp=192, start_disp=0,
                            dilation=1, alpha=1.0, normalize=True),
        losses=dict(
            l1_loss=dict(max_disp=192, weights=(1.0, 0.7, 0.5), weight=1.0),
        ),
        eval=dict(lower_bound=0, upper_bound=192, eval_occlusion=True,
                  batch_size=4,
                  # fuse trilinear upsample + soft-argmin at eval into one
                  # kernel that never writes the full-resolution volume
                  fused_upsample_argmin=False),
    ),
    data=dict(
        type="SceneFlow",
        sparse=False,
        batch_size_per_device=3,
        mean=(123.675, 116.28, 103.53),
        std=(58.395, 57.12, 57.375),
        train=dict(input_shape=(256, 512), use_right_disp=False),
        eval=dict(input_shape=(544, 960), use_right_disp=False),
        test=dict(input_shape=(544, 960), use_right_disp=False),
    ),
    optimizer=dict(type="rmsprop", lr=0.001),
    grad_clip=dict(max_norm=35.0),
    lr_schedule=dict(policy="step", warmup="linear", warmup_iters=500,
                     warmup_ratio=1.0 / 3, step=(10,), gamma=0.1),
    checkpoint=dict(interval=1),
    total_epochs=10,
    eval_disparity_id=(0, 1, 2),
)


def _apply_overrides(cfg, overrides):
    """Set dotted keys ('model.max_disp') of the nested dict in place."""
    for key, val in overrides.items():
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node[p]
        node[parts[-1]] = val
    return cfg


def scene_flow(**overrides):
    return _apply_overrides(copy.deepcopy(_BASE), overrides)


def _kitti(dataset_type):
    cfg = copy.deepcopy(_BASE)
    cfg["data"].update(type=dataset_type, sparse=True)
    cfg["data"]["train"]["input_shape"] = (256, 512)
    cfg["data"]["eval"]["input_shape"] = (384, 1248)
    cfg["data"]["test"]["input_shape"] = (384, 1248)
    cfg["lr_schedule"]["step"] = (100, 300)
    cfg["total_epochs"] = 500
    return cfg


def kitti_2015(**overrides):
    return _apply_overrides(_kitti("KITTI-2015"), overrides)


def kitti_2012(**overrides):
    """KITTI-2012 fine-tune config: kitti_2015 with the 2012 data layout."""
    return _apply_overrides(_kitti("KITTI-2012"), overrides)
