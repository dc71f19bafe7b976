"""3x3x3 stride-1 SAME conv3d + per-channel scale/bias (+ReLU) epilogue.

Replaces the TPU kernel densematchingbenchmark_tpu/ops/pallas/
conv3d_kernel.py::fused_conv3d (body ``_kernel``): the eval-mode
conv + folded BatchNorm (+ReLU) unit of the PSMNet aggregation trunk, 13
launches per forward. Hopper kernel: ``csrc/conv3d_kernel.cu`` (CUDA C++,
sm_90a), the float32 block on the CUDA cores that K4's float32 route runs
too (``csrc/conv3d_tile.cuh``); the note there says what bounds it (the f32
FMA rate) and how the design meets it. Its weight image and launch plan are
K4's (``packed_conv3d_kernel.conv3d_f32_weights`` and ``f32_plan``, pack
1).

``conv3d_plain`` is the same function in plain PyTorch: the sum over the 27
taps of a shifted [N, Cin] x [Cin, Cout] product, the arithmetic the kernel
does, followed by the epilogue.
"""

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_SIGNATURES = {
    # pointers, the shapes and relu (7), the launch plan (7), the stream
    "conv3d_bn_act_f32": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 14 + [ctypes.c_void_p],
        ctypes.c_int),
    "conv3d_bn_act_f32_residency": ([ctypes.c_int] * 3, ctypes.c_int),
    "conv3d_bn_act_f32_regs": ([ctypes.c_int], ctypes.c_int),
}


def conv3d_plain(x, kernel, scale, bias, relu):
    """Plain PyTorch version: x [B, D, H, W, Cin], kernel [3, 3, 3, Cin,
    Cout], scale / bias [Cout] -> float32 [B, D, H, W, Cout] (float64 for a
    float64 x, which the card's checks take as a reference)."""
    b, d, h, w, _ = x.shape
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    out = x.new_zeros((b, d, h, w, kernel.shape[-1]))
    for dd in range(3):
        for dh in range(3):
            for dw in range(3):
                out += xp[:, dd:dd + d, dh:dh + h, dw:dw + w] @ \
                    kernel[dd, dh, dw].to(x.dtype)
    out = out * scale + bias
    return out.clamp_min(0.0) if relu else out


def fused_conv3d(x, kernel, scale=None, bias=None, relu=False):
    """3x3x3 stride-1 SAME conv with a fused scale/bias/ReLU epilogue.

    Args:
      x: [B, D, H, W, Cin] float32, contiguous (NDHWC).
      kernel: [3, 3, 3, Cin, Cout] float32 (DHWIO).
      scale, bias: [Cout] epilogue (a folded eval BatchNorm); default 1 / 0.
      relu: apply max(0, .) after the epilogue.

    Returns: [B, D, H, W, Cout] float32. A CPU tensor runs ``conv3d_plain``;
    a CUDA tensor launches the kernel or raises.
    """
    cin, cout = kernel.shape[-2:]
    if scale is None:
        scale = x.new_ones(cout, dtype=torch.float32)
    if bias is None:
        bias = x.new_zeros(cout, dtype=torch.float32)
    if x.device.type == "cpu":
        return conv3d_plain(x, kernel, scale, bias, relu)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv3d: unsupported device {x.device}")
    if x.dim() != 5 or tuple(kernel.shape) != (3, 3, 3, x.shape[-1], cout):
        raise ValueError(f"fused_conv3d: x {tuple(x.shape)} and kernel "
                         f"{tuple(kernel.shape)} are not [B,D,H,W,Cin] and "
                         "[3,3,3,Cin,Cout]")
    if tuple(scale.shape) != (cout,) or tuple(bias.shape) != (cout,):
        raise ValueError("fused_conv3d: scale and bias must be [Cout]")
    if cin % 4 or cout % 4:
        raise ValueError(f"fused_conv3d: Cin {cin} and Cout {cout} must be "
                         "multiples of 4 (16-byte vector loads)")
    tensors = (x, kernel, scale, bias)
    for t in tensors:
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError("fused_conv3d: all operands must be float32 on "
                             f"{x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("fused_conv3d: operands must be contiguous and "
                             "16-byte aligned")
    b, d, h, w, _ = x.shape
    if x.numel() >= 2 ** 31 or x.numel() // cin * cout >= 2 ** 31:
        raise ValueError(f"fused_conv3d: volume {tuple(x.shape)} too large")
    out = torch.empty((b, d, h, w, cout), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    # the weight image and plan are K4's (that module imports this one)
    from .packed_conv3d_kernel import F32_PLAN_ARGS, conv3d_f32_weights, \
        f32_plan
    with torch.cuda.device(x.device):
        lib = _build.load("conv3d_kernel", _SIGNATURES)
        plan = f32_plan(lib, "conv3d_bn_act", x.device.index, b, d, 1, h, w,
                        cin, cout)
        image = conv3d_f32_weights(kernel, plan["cob"])
        err = lib.conv3d_bn_act_f32(
            x.data_ptr(), image.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), out.data_ptr(), b, d, h, w, cin, cout,
            int(bool(relu)), *(plan[k] for k in F32_PLAN_ARGS),
            _build.current_stream(x.device))
    _build.check_launch(err, "fused_conv3d")
    fused_conv3d.launches += 1
    return out


fused_conv3d.launches = 0
