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
it. Its tap tables are made on the host as the reference makes them and
kept on the device per shape (``kernel_tables``), so a launch copies
nothing from the host.

``upsample_soft_argmin_plain`` is the same function in plain PyTorch:
``upsample_3d`` then the plain soft-argmin on the materialized volume.
"""

import ctypes
import functools

import numpy as np
import torch

from ..cost_volume import disp_sample_tensor, disp_sample_values
from ..interpolate import _axis_taps, upsample_3d
from . import _build
from .soft_argmin_kernel import soft_argmin_plain

# output rows and columns per block, and the dynamic shared memory a block
# may have, as in the CUDA source
_TY, _TX = 16, 64
_MAX_SMEM = 232448

_SIGNATURES = {
    "upsample_soft_argmin_f32": (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
        + [ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int),
}


def upsample_soft_argmin_plain(low_cost, out_d, out_h, out_w, vals,
                               alpha=1.0):
    """Plain PyTorch version: [B, D', H', W'] -> [B, out_h, out_w, 1]."""
    full = upsample_3d(low_cost.float(), out_d, out_h, out_w,
                       align_corners=True)
    return soft_argmin_plain(full, vals, alpha)


def _axis_table(in_size, out_size, extra=None):
    """int32 [out_size, 4]: the align_corners=True taps of one axis (i0, i1,
    the float32 weight's bits) and ``extra``'s float32 bits (or 0)."""
    i0, i1, w = _axis_taps(in_size, out_size, align_corners=True)
    last = np.zeros(out_size, np.float32) if extra is None else extra
    return np.stack([i0.astype(np.int32), i1.astype(np.int32),
                     w.view(np.int32), last.view(np.int32)], axis=1)


def _interval_table(d_in, i0, w):
    """int32 [max(D' - 1, 1), 4]: per source interval k (the upsampled
    depths j with i0(j) == k; i0 never decreases), its first j, one past
    its last, and the float32 weights of the two as bits (0 where it holds
    no j)."""
    k = np.arange(max(d_in - 1, 1))
    ja = np.searchsorted(i0, k, side="left")
    jb = np.searchsorted(i0, k, side="right")
    full = ja < jb
    fa = np.where(full, w[np.minimum(ja, len(w) - 1)], np.float32(0))
    fb = np.where(full, w[np.maximum(jb - 1, 0)], np.float32(0))
    return np.stack([ja.astype(np.int32), jb.astype(np.int32),
                     fa.astype(np.float32).view(np.int32),
                     fb.astype(np.float32).view(np.int32)], axis=1)


def _span(i0, i1, tile):
    """The most source indices one tile of ``tile`` outputs reads."""
    first = i0[::tile]
    last = i1[np.minimum(np.arange(tile, len(i1) + tile, tile), len(i1)) - 1]
    return int((last - first).max()) + 1


@functools.lru_cache(maxsize=64)
def kernel_tables(d_in, h_in, w_in, out_d, out_h, out_w, start_disp,
                  dilation, device):
    """The kernel's tap tables on ``device``, made once per key and kept (a
    copy from the host per call would make every launch wait for the work
    queued before it): (dtab, htab, wtab, SR, SC, itab). dtab [out_d, 4] holds
    the depth taps and the sample values, htab and wtab the H and W taps,
    all int32 (``_axis_table``); SR x SC is the largest source patch (rows
    x columns) of one output tile; itab [max(D' - 1, 1), 4] the source
    intervals' depths (``_interval_table``). Callers must not write to
    them."""
    vals = disp_sample_values(out_d * dilation, start_disp, dilation)
    i0, _, w = _axis_taps(d_in, out_d, align_corners=True)
    tables = [_axis_table(d_in, out_d, vals), _axis_table(h_in, out_h),
              _axis_table(w_in, out_w), _interval_table(d_in, i0, w)]
    sr = _span(tables[1][:, 0], tables[1][:, 1], _TY)
    sc = _span(tables[2][:, 0], tables[2][:, 1], _TX)
    with torch.inference_mode(False):   # usable later under autograd
        dtab, htab, wtab, itab = (torch.as_tensor(t, device=device)
                                  for t in tables)
    return dtab, htab, wtab, sr, sc, itab


@functools.lru_cache(maxsize=64)
def _launch_plan(shape, out_d, out_h, out_w, start_disp, dilation, device):
    """For a [B, D', H', W'] float32 cost of ``shape``: (the kept tables,
    their pointers, the launch's int arguments), made once per call shape;
    raises on a shape the kernel cannot take."""
    b, d_in, h_in, w_in = shape
    tiles = -(-out_h // _TY) * -(-out_w // _TX)
    n = b * d_in * h_in * w_in
    if n == 0 or n >= 2 ** 31 or b * out_h * out_w >= 2 ** 31 \
            or b * tiles >= 2 ** 31:
        raise ValueError(f"fused_upsample_soft_argmin: cost {shape} is "
                         "empty or too large")
    # the depth taps in shared memory (table_bytes in the CUDA source), and
    # the tile's source patch too where it fits
    table_bytes = 16 * d_in + 8 * out_d
    if table_bytes > _MAX_SMEM:
        raise ValueError(f"fused_upsample_soft_argmin: out_d {out_d} and "
                         f"D' {d_in} need {table_bytes} B of shared memory")
    dtab, htab, wtab, sr, sc, itab = kernel_tables(
        d_in, h_in, w_in, out_d, out_h, out_w, start_disp, dilation, device)
    smem = 4 * d_in * sr * sc
    staged = smem + table_bytes <= _MAX_SMEM
    tables = (dtab, itab, htab, wtab)
    return (tables, tuple(t.data_ptr() for t in tables),
            (b, d_in, h_in, w_in, out_d, out_h, out_w, sr, sc, int(staged),
             smem if staged else 0))


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
    if low_cost.dim() != 4:
        raise ValueError("fused_upsample_soft_argmin: cost must be "
                         f"[B, D', H', W'], got {tuple(low_cost.shape)}")
    if device.type == "cpu":
        vals = disp_sample_tensor(out_d * dilation, start_disp, dilation,
                                  device)
        return upsample_soft_argmin_plain(low_cost, out_d, out_h, out_w,
                                          vals, alpha)
    if device.type != "cuda":
        raise ValueError(f"fused_upsample_soft_argmin: unsupported device "
                         f"{device}")
    if low_cost.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_upsample_soft_argmin: dtype "
                         f"{low_cost.dtype}")
    low = low_cost.float().contiguous()
    out = torch.empty((low.shape[0], out_h, out_w, 1), dtype=torch.float32,
                      device=device)
    if out.numel() == 0:
        return out
    _, tables, ints = _launch_plan(tuple(low.shape), out_d, out_h, out_w,
                                   start_disp, dilation, device)
    with torch.cuda.device(device):
        lib = _build.load("upsample_argmin_kernel", _SIGNATURES)
        err = lib.upsample_soft_argmin_f32(
            low.data_ptr(), *tables, out.data_ptr(), *ints, float(alpha),
            _build.current_stream(device))
    _build.check_launch(err, "fused_upsample_soft_argmin")
    fused_upsample_soft_argmin.launches += 1
    return out


fused_upsample_soft_argmin.launches = 0
