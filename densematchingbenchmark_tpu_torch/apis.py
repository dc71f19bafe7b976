"""Library inference API: init_model / inference_stereo, and for flow
init_flow_model / inference_flow.

Counterpart of densematchingbenchmark_tpu/apis.py:95-252: build a model
from a config (its weights from a seed, or restored from the port's own
checkpoint), then run stereo inference over image pairs with pad-to-shape
(or center crop), optional scaling (disparity values rescale with width)
and padding removal, or flow inference over frame pairs with
pad-to-shape and the flows cropped back. The JAX package's TPU
compile-failure schedule ladder (:23-92) has no counterpart: the port has
one schedule.

Models run on ``cuda`` unless the caller passes ``device="cpu"``; with no
GPU and no device given, ``init_model`` and ``init_flow_model`` raise
rather than carry on on the CPU. ``init_distributed``
(parallel/distributed.py) joins a process to a data-parallel group; after
it, the default device is the rank's.
"""

import numpy as np
import torch

from .configs import get_config
from .data import transforms
from .evaluation.metrics import remove_padding
from .models import build_model
from .ops.interpolate import resize_linear
from .parallel.distributed import init_distributed  # noqa: F401 (exported)
from .parallel.distributed import rank_device
from .utils.checkpoint import CheckpointManager


class StereoModel:
    """A built model (stereo or flow) on its device, in eval mode, with
    its config."""

    def __init__(self, cfg, module, device):
        self.cfg = cfg
        self.module = module
        self.device = device

    def forward(self, left, right):
        """[B, H, W, 3] normalized images on ``device`` -> the model's
        result dict ('disps', 'costs', or a flow model's 'flows'; best
        first)."""
        with torch.inference_mode():
            return self.module(left, right)


def resolve_device(device=None):
    """``device``; by default the rank's device in a process group
    (parallel.init_distributed), else ``cuda``, which needs a GPU."""
    if device is None:
        if rank_device() is not None:
            return rank_device()
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU; pass "
                "device='cpu' to run the plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _init_module(config_name_or_cfg, device, seed, checkpoint_dir,
                 overrides):
    """(cfg, module on ``device`` in eval mode) of init_model and
    init_flow_model; on a CUDA device TF32 is turned off."""
    device = resolve_device(device)
    cfg = (get_config(config_name_or_cfg, **overrides)
           if isinstance(config_name_or_cfg, str) else config_name_or_cfg)
    module = build_model(cfg, torch.Generator().manual_seed(seed))
    if checkpoint_dir:
        saved, _ = CheckpointManager(checkpoint_dir).restore()
        if saved is not None:
            module.load_state_dict(saved["module"])
    module.to(device).eval()
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return cfg, module, device


def init_model(config_name_or_cfg, device=None, seed=0, checkpoint_dir=None,
               **overrides):
    """Build a StereoModel with parameters initialised from ``seed``; with
    ``checkpoint_dir``, restore the parameters and BN statistics of the
    latest checkpoint under <checkpoint_dir>/checkpoints/ (written by
    ``train_matcher``), and keep the seeded ones when there is none.

    The compute dtype is the config's ``model.dtype``: a ``_bf16`` name (or
    a name without a suffix on a machine with a GPU, as in the JAX package)
    computes in bfloat16 with float32 parameters and BN statistics, a
    ``_f32`` name in float32. On a CUDA device this sets
    ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` to False: the float32 configs
    compute in float32, as the JAX package does, and TF32 library convs
    round to a 10-bit mantissa, which soft-argmin amplifies into whole-pixel
    errors (docs/DESIGN.md section 8).
    """
    return StereoModel(*_init_module(config_name_or_cfg, device, seed,
                                     checkpoint_dir, overrides))


def _resize(img, size, align_corners=False):
    """[..., H, W, C] numpy -> numpy resized on the host."""
    x = torch.from_numpy(np.ascontiguousarray(img))
    return resize_linear(x, size, (x.dim() - 3, x.dim() - 2),
                         align_corners).numpy()


def inference_stereo(model, batches, pad_to_shape=None, crop_shape=None,
                     scale_factor=None, disp_div_factor=1.0):
    """Run inference over a list of {'leftImage', 'rightImage'[, names]}.

    Args:
      model: StereoModel from init_model.
      batches: list of dicts with [H, W, 3] float images (0-255).
      pad_to_shape / crop_shape: preprocessing geometry (pad top + right,
        or center crop).
      scale_factor: optional resize before inference; the predicted
        disparity is resized back and its values divided accordingly.
      disp_div_factor: divide output disparity values.

    Returns:
      list of result dicts with 'disps' (numpy [1, H, W, 1], original size,
      best first).
    """
    mean, std = model.cfg["data"]["mean"], model.cfg["data"]["std"]
    results = []
    for item in batches:
        left, right = item["leftImage"], item["rightImage"]
        orig_h, orig_w = left.shape[:2]
        sample = {"leftImage": left.astype(np.float32),
                  "rightImage": right.astype(np.float32)}
        scaled = scale_factor is not None and scale_factor != 1.0
        if scaled:
            nh = int(round(orig_h * scale_factor))
            nw = int(round(orig_w * scale_factor))
            for k in ("leftImage", "rightImage"):
                sample[k] = _resize(sample[k], (nh, nw))
        if crop_shape is not None:
            sample = transforms.center_crop(sample, crop_shape)
        if pad_to_shape is not None:
            sample = transforms.pad_to(sample, pad_to_shape)
        sample = transforms.normalize(sample, mean, std)

        li, ri = (torch.from_numpy(np.ascontiguousarray(sample[k]))[None]
                  .to(model.device) for k in ("leftImage", "rightImage"))
        out = model.forward(li, ri)

        disps = []
        for d in out["disps"]:
            d = d.float().cpu().numpy()
            if pad_to_shape is not None:
                inner_h = int(round(orig_h * (scale_factor or 1.0)))
                inner_w = int(round(orig_w * (scale_factor or 1.0)))
                d = remove_padding(d, inner_h, inner_w)
            if scaled:
                d = _resize(d, (orig_h, orig_w)) / scale_factor
            disps.append(d / disp_div_factor)
        result = dict(item)
        result["disps"] = disps
        results.append(result)
    return results


def init_flow_model(config_name_or_cfg, device=None, seed=0,
                    checkpoint_dir=None, **overrides):
    """Build a StereoModel holding a flow model (PWCFlow or RAFT; its
    ``forward`` returns {'flows': [...]}, best first) as ``init_model``
    builds one: parameters from ``seed`` or the latest checkpoint under
    <checkpoint_dir>/checkpoints/, on ``cuda`` unless ``device`` says
    otherwise (raising without a GPU), TF32 off on the card."""
    cfg, module, device = _init_module(config_name_or_cfg, device, seed,
                                       checkpoint_dir, overrides)
    if cfg.get("task") != "flow":
        raise ValueError(f"init_flow_model: {config_name_or_cfg!r} is not "
                         "a flow config (its task is not 'flow')")
    return StereoModel(cfg, module, device)


def inference_flow(model, batches, pad_to_shape=None):
    """Optical-flow inference over [{'leftImage', 'rightImage'[, names]}]
    with [H, W, 3] float frames (0-255, frames t and t + 1).
    ``pad_to_shape`` pads bottom and right with zeros to a shape the
    model takes (PWCFlow: sides multiples of 16; RAFT: of 8); each
    returned flow is cropped to [:H, :W] (a lower-resolution level of
    PWCFlow's pyramid keeps its own size where that is smaller, as in the
    JAX package). Returns the items with 'flows' (numpy [1, h, w, 2]
    float32, best first)."""
    from .flow import transforms as ftrans

    mean, std = model.cfg["data"]["mean"], model.cfg["data"]["std"]
    results = []
    for item in batches:
        left, right = item["leftImage"], item["rightImage"]
        orig_h, orig_w = left.shape[:2]
        sample = {"leftImage": left.astype(np.float32),
                  "rightImage": right.astype(np.float32)}
        if pad_to_shape is not None:
            sample = ftrans.pad_to(sample, pad_to_shape)
        sample = ftrans.normalize(sample, mean, std)
        li, ri = (torch.from_numpy(np.ascontiguousarray(sample[k]))[None]
                  .to(model.device) for k in ("leftImage", "rightImage"))
        out = model.forward(li, ri)
        result = dict(item)
        result["flows"] = [f.float().cpu().numpy()[:, :orig_h, :orig_w]
                           for f in out["flows"]]
        results.append(result)
    return results
