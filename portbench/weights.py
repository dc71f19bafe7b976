"""Seeded weights, drawn by the benchmark and handed to both sides.

Every float tensor of a module's state (parameters and BatchNorm
statistics, float32 as the program keeps them) is drawn on the device
from one ``torch.Generator`` seeded with the run's seed, in three large
calls over flat buffers:

- convolution weights: a unit normal cut at +-2, scaled to LeCun's
  normal for convolutions and He's for transposed ones (fan-in of the
  weight), as the configurations' initialisers;
- convolution biases and BatchNorm shifts and running means: uniform in
  [-0.1, 0.1];
- BatchNorm scales uniform in [0.8, 1.2], running variances in
  [0.8, 1.25],

so that the conv bias, the BatchNorm fold and its statistics all carry
values that a fault in them would change. Integer buffers keep their
values.
"""

import math

import torch
from torch import nn

TRUNC_STD = 0.87962566103423978   # std of a unit normal cut at +-2


def _kinds(module):
    """{state name: (kind, std)} of the float tensors of ``module``."""
    kinds = {}
    for prefix, m in module.named_modules():
        p = prefix + "." if prefix else ""
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d,
                          nn.ConvTranspose3d)):
            transposed = isinstance(m, (nn.ConvTranspose2d,
                                        nn.ConvTranspose3d))
            fan_in = m.in_channels // m.groups * math.prod(m.kernel_size)
            std = math.sqrt((2.0 if transposed else 1.0) / fan_in)
            kinds[p + "weight"] = ("normal", std / TRUNC_STD)
            if m.bias is not None:
                kinds[p + "bias"] = ("shift", None)
        elif isinstance(m, nn.modules.batchnorm._NormBase):
            kinds[p + "weight"] = ("scale", None)
            kinds[p + "bias"] = ("shift", None)
            kinds[p + "running_mean"] = ("shift", None)
            kinds[p + "running_var"] = ("var", None)
    return kinds


def seeded_state(module, seed, device):
    """{name: float32 tensor on ``device``} for every float tensor of
    ``module``'s state, drawn from ``seed``."""
    state = module.state_dict()
    kinds = _kinds(module)
    names = [k for k, v in state.items() if v.is_floating_point()]
    unknown = [k for k in names if k not in kinds]
    if unknown:
        raise KeyError(f"no rule to draw {unknown[:5]}")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    groups = {"normal": [], "uniform": []}
    for k in names:
        groups["normal" if kinds[k][0] == "normal" else "uniform"].append(k)
    out = {}
    for group, keys in groups.items():
        sizes = [state[k].numel() for k in keys]
        flat = torch.empty(sum(sizes), device=device)
        if group == "normal":
            nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
        else:
            flat.uniform_(0.0, 1.0, generator=gen)
        for k, part in zip(keys, flat.split(sizes)):
            kind, std = kinds[k]
            part = part.view(state[k].shape)
            if kind == "normal":
                part = part * std
            elif kind == "shift":
                part = part * 0.2 - 0.1
            elif kind == "scale":
                part = part * 0.4 + 0.8
            else:
                part = part * 0.45 + 0.8
            out[k] = part.contiguous()
    return out


def load_into(module, weights):
    """Copy ``weights`` into ``module`` (every float tensor of its state;
    integer buffers are left as they are)."""
    state = module.state_dict()
    missing = [k for k, v in state.items()
               if v.is_floating_point() and k not in weights]
    if missing:
        raise KeyError(f"weights lack {missing[:5]}")
    with torch.no_grad():
        for k, v in weights.items():
            state[k].copy_(v)
