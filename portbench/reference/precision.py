"""Operand precision of the plain reference's convolutions.

``float32`` leaves every operand as it is: the reference proper. ``fp8``
is the control, the step below the bfloat16 the configurations state:
each convolution's input and weight rounded to float8 e4m3 with one
scale a tensor (its largest magnitude maps to e4m3's largest finite
value, 448), products summed in float32, everything else (BatchNorm,
the cost volume, the upsample, the soft-argmin) in float32. ``bf16``
rounds the same operands to bfloat16 instead: the configurations' own
precision, emulated, which calibrate.py reads beside the program to show
how much of the program's gap bfloat16 alone accounts for.
"""

import torch

E4M3_MAX = 448.0


def identity(x):
    return x


def fp8_e4m3(x):
    """``x`` rounded to float8 e4m3 under a per-tensor scale, returned in
    float32."""
    amax = x.detach().abs().amax()
    if amax == 0:
        return x
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def bf16(x):
    """``x`` rounded to bfloat16, returned in float32."""
    return x.to(torch.bfloat16).float()


PRECISIONS = {"float32": identity, "fp8": fp8_e4m3, "bf16": bf16}


def rounding(name):
    """The rounding applied to convolution operands under ``name``."""
    if name not in PRECISIONS:
        raise KeyError(f"precision {name!r}: one of {sorted(PRECISIONS)}")
    return PRECISIONS[name]
