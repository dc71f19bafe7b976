"""The yardstick's arithmetic: the card's published peaks, the trunk
units' least time, and the operations of a forward counted on the
reference.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at its 700 W limit:
989e12 bf16 FLOP/s on the tensor cores, 3.35e12 bytes/s of HBM3. A card
set below 700 W (``nvidia-smi --query-gpu=power.limit``) reaches less;
PERF.md states each share with the card's limit beside it.

The trunk units are the 3x3x3 stride-1 conv + BatchNorm (+ ReLU) units of
the 3-D aggregator that the port runs on its hand-written bfloat16
kernel (13 a forward in PSMNet and AcfNet). A call's least time is the
larger of its true multiply-adds at the model's widths (two FLOPs each)
over the bf16 peak and its operands (the input and the output volume in
bfloat16, the 27 Ci Co weights in bfloat16, the folded scale and shift in
float32), each read or written once, over the bandwidth. The strided,
transposed and Co = 1 convolutions, the BatchNorm of training and every
backward convolution run on cuDNN: they are in neither the bound nor the
kernel time that ``trunk_roofline`` divides it by.
"""

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# the kernels that carry the trunk units' calls, by a part of their name
TRUNK_KERNEL = "conv3d_wgmma"


def trunk_call_bound_s(voxels, ci, co):
    """Least seconds of one trunk call over ``voxels`` output voxels
    (batch x depth x height x width)."""
    flops = 2 * 27 * ci * co * voxels
    nbytes = 2 * (voxels * (ci + co) + 27 * ci * co) + 2 * 4 * co
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def trunk_bound_s(calls):
    """Least seconds of the trunk calls [(voxels, ci, co), ...]."""
    return sum(trunk_call_bound_s(*c) for c in calls)


def count_flops(family, max_disp, height, width, batch=1):
    """Convolution FLOPs (two a multiply-add) of one eval forward of the
    reference ``family`` on ``batch`` frames of ``height`` x ``width``,
    counted on fake tensors: shapes only, nothing computed. Elementwise
    work (BatchNorm, the upsample, the soft-argmin) is not counted."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from .reference.stereo import FAMILIES, StereoReference
    model = StereoReference(max_disp, FAMILIES[family]).eval()
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.empty(batch, 3, height, width)
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            model(x, x)
    return counter.get_total_flops()
