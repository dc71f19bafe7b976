"""Fused trilinear upsample + soft-argmin.

Replaces the TPU kernel densematchingbenchmark_tpu/ops/pallas/
upsample_argmin_kernel.py::fused_upsample_soft_argmin (body ``_kernel``,
taps ``_interp_matrix``): a low-resolution [B, D', H', W'] cost is upsampled
trilinearly (align_corners=True) to (out_d, out_h, out_w) and reduced by the
softmax-expectation over out_d, without writing the full-resolution volume.
On the PSMNet eval path with ``model.eval.fused_upsample_argmin`` it runs 3
times per forward, [1, 48, 96, 312] -> [1, 384, 1248, 1]. Hopper kernel:
``csrc/upsample_argmin_kernel.cu`` (CUDA C++, sm_90a); the source note there
says what bounds it (the exps and lerps, not bytes) and how the design meets
it.

``upsample_soft_argmin_plain`` is the same function in plain PyTorch:
``upsample_3d`` then the plain soft-argmin on the materialized volume.
"""

import ctypes

import torch

from ..cost_volume import disp_sample_values
from ..interpolate import _axis_taps, upsample_3d
from . import _build
from .soft_argmin_kernel import soft_argmin_plain

_NT = 128                      # threads per block, as in the CUDA source
_MAX_SMEM = 227 * 1024         # shared memory a block may use on sm_90

_SIGNATURES = {
    "upsample_soft_argmin_f32": (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int),
}


def upsample_soft_argmin_plain(low_cost, out_d, out_h, out_w, vals,
                               alpha=1.0):
    """Plain PyTorch version: [B, D', H', W'] -> [B, out_h, out_w, 1]."""
    full = upsample_3d(low_cost.float(), out_d, out_h, out_w,
                       align_corners=True)
    return soft_argmin_plain(full, vals, alpha)


def _taps(in_size, out_size, device):
    """align_corners=True taps of one axis as device tensors (i0, i1, w)."""
    i0, i1, w = _axis_taps(in_size, out_size, align_corners=True)
    return (torch.as_tensor(i0, dtype=torch.int32, device=device),
            torch.as_tensor(i1, dtype=torch.int32, device=device),
            torch.as_tensor(w, dtype=torch.float32, device=device))


def fused_upsample_soft_argmin(low_cost, out_d, out_h, out_w, start_disp=0,
                               dilation=1, alpha=1.0):
    """[B, D', H', W'] low-res cost -> [B, out_h, out_w, 1] float32.

    Equivalent to soft_argmin(upsample_3d(low_cost, out_d, out_h, out_w,
    align_corners=True), max_disp=out_d * dilation, start_disp, dilation,
    alpha). A CPU tensor runs ``upsample_soft_argmin_plain``; a CUDA tensor
    launches the kernel or raises. bf16 input is promoted to float32, as the
    TPU kernel does.
    """
    device = low_cost.device
    vals = torch.as_tensor(
        disp_sample_values(out_d * dilation, start_disp, dilation),
        device=device)
    if len(vals) != out_d:
        raise ValueError(f"fused_upsample_soft_argmin: range gives "
                         f"{len(vals)} samples, out_d is {out_d}")
    if low_cost.dim() != 4:
        raise ValueError("fused_upsample_soft_argmin: cost must be "
                         f"[B, D', H', W'], got {tuple(low_cost.shape)}")
    if device.type == "cpu":
        return upsample_soft_argmin_plain(low_cost, out_d, out_h, out_w,
                                          vals, alpha)
    if device.type != "cuda":
        raise ValueError(f"fused_upsample_soft_argmin: unsupported device "
                         f"{device}")
    if low_cost.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_upsample_soft_argmin: dtype "
                         f"{low_cost.dtype}")
    low = low_cost.float().contiguous()
    b, d_in, h_in, w_in = low.shape
    smem = 4 * (d_in * _NT + 4 * out_d)
    if smem > _MAX_SMEM:
        raise ValueError(f"fused_upsample_soft_argmin: D'={d_in}, out_d="
                         f"{out_d} need {smem} B of shared memory")
    if low.numel() == 0 or low.numel() >= 2 ** 31 \
            or b * out_h * out_w >= 2 ** 31:
        raise ValueError(f"fused_upsample_soft_argmin: cost "
                         f"{tuple(low.shape)} is empty or too large")
    out = torch.empty((b, out_h, out_w), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out[..., None]
    tables = (*_taps(d_in, out_d, device), *_taps(h_in, out_h, device),
              *_taps(w_in, out_w, device), vals)
    lib = _build.load("upsample_argmin_kernel", _SIGNATURES)
    err = lib.upsample_soft_argmin_f32(
        low.data_ptr(), *(t.data_ptr() for t in tables), out.data_ptr(),
        b, d_in, h_in, w_in, out_d, out_h, out_w, float(alpha),
        _build.current_stream())
    _build.check_launch(err, "fused_upsample_soft_argmin")
    fused_upsample_soft_argmin.launches += 1
    return out[..., None]


fused_upsample_soft_argmin.launches = 0
