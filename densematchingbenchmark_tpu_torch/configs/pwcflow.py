"""Optical-flow configs on FlyingChairs: PWCFlow and RAFT.

Counterpart of densematchingbenchmark_tpu/configs/pwcflow.py, kept as this
package's own copy with the same field names and values: FlyingChairs'
384x512 frames, the 320x448 train crop, batch 8, Adam; PWCFlow's loss
weights best first (the full-resolution flow, then the pyramid fine to
coarse), RAFT's the final convex-upsampled flow at 1.0 and each
iteration's at 0.8^k, latest first.
"""

import copy

from .psmnet import _BASE, _apply_overrides


def flying_chairs(**overrides):
    cfg = copy.deepcopy(_BASE)
    cfg["task"] = "flow"
    cfg["model"] = dict(
        meta_architecture="PWCFlow",
        chans=(16, 32, 64, 96),
        radius=4,
        hidden=96,
        batch_norm=True,
        dtype="float32",
        losses=dict(
            flow_l1_loss=dict(weights=(1.0, 1.0, 0.5, 0.25, 0.125),
                              weight=1.0),
        ),
        eval=dict(sparse=False),
    )
    cfg["data"].update(
        type="FlyingChairs",
        crop_size=(320, 448),
        pad_to_size=(384, 512),
        batch_size_per_device=8,
    )
    cfg["optimizer"].update(type="adam", lr=1e-4)
    cfg["total_epochs"] = 30
    return _apply_overrides(cfg, overrides)


def raft_flying_chairs(**overrides):
    iters = 8
    cfg = flying_chairs()
    cfg["model"] = dict(
        meta_architecture="RAFTFlow",
        iters=iters,
        radius=3,
        levels=4,
        hidden=96,
        context=64,
        batch_norm=True,
        dtype="float32",
        losses=dict(
            flow_l1_loss=dict(
                weights=(1.0,) + tuple(0.8 ** k for k in range(iters)),
                weight=1.0),
        ),
        eval=dict(sparse=False),
    )
    cfg["optimizer"].update(type="adam", lr=4e-4)
    return _apply_overrides(cfg, overrides)
