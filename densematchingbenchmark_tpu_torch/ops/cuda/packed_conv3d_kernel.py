"""3x3x3 stride-1 SAME conv3d + scale/bias (+ReLU) on the D-packed layout:
K4 (differentiable) and K5 (forward only), float32 or bfloat16 operands.

``conv3d_packed_s1`` (K4) replaces the TPU kernel densematchingbenchmark_tpu/
ops/pallas/packed_conv3d_kernel.py::conv3d_packed_s1_pallas (forward
``_forward`` / ``_kernel``, custom VJP ``_pallas_vjp``): the stride-1 conv of
the 13 trunk units of PSMNet's aggregator in training (pack 1, float32, 13
launches per train step) and the v1 row of the packed-conv microbench
(tools/microbench_packed.py, pack 4). Hopper kernel:
``csrc/packed_conv3d_kernel.cu`` (CUDA C++, sm_90a), its own kernel and
launch counter around K1's implicit-GEMM block (``csrc/conv3d_tile.cuh``)
with the packed layout as addressing; the note there says what bounds it and
how the design meets it.

``conv3d_packed_s1_v2`` (K5) replaces ``conv3d_packed_s1_pallas_v2`` (body
``_kernel_v2``, the rolling-DMA ring): the same function, forward only, as
in JAX; its only caller is the microbench. Hopper kernel:
``csrc/packed_conv3d_v2_kernel.cu``, which walks depth inside the block so
that each input plane is staged once per H / W tile (its note says how).

Both take float32 or bfloat16 ``xp`` and return ``xp.dtype``, as JAX's
contract: the kernel is cast to ``xp.dtype`` first (weights rounded once, as
JAX's ``wmat.astype(xp.dtype)``), products are summed in float32, the
epilogue (float32 scale and bias) runs in float32 and the result is rounded
once to ``xp.dtype``. Neither takes ``h_tile``: that is a TPU schedule knob,
and the kernels mask ragged H and W.

K4's gradient is, as JAX's ``_bwd``, the VJP of the plain convolution and no
hand-written kernel: the TPU package computes it in XLA outside any Pallas
kernel (``_xla_reference``, in ``xp.dtype``), and here cuDNN's convolution
gradients run on the unpacked view in the same dtype, with the epilogue and
ReLU terms in float32.

``conv3d_packed_s1_plain`` is the function of both in plain PyTorch: unpack,
``conv3d_plain`` (K1's plain version, float32), pack, epilogue, one rounding
to ``xp.dtype``; on the CPU it is differentiable by plain autograd.
"""

import ctypes

import torch
import torch.nn.functional as F

from ..conv3d import pack_volume, unpack_volume
from . import _build
from .conv3d_kernel import conv3d_plain

_SIGNATURE = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
              ctypes.c_int)
_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# wrapper name -> (library, symbol prefix)
_LIBRARIES = {"conv3d_packed_s1": ("packed_conv3d_kernel", "packed_conv3d"),
              "conv3d_packed_s1_v2": ("packed_conv3d_v2_kernel",
                                      "packed_conv3d_v2")}


def full_epilogue(v, pack, co, device):
    """A scalar, [Co] or [pack*Co] epilogue term -> float32 [pack*Co], as
    JAX's ``_full_epilogue``; differentiable in ``v`` when it is a tensor."""
    v = torch.as_tensor(v, dtype=torch.float32, device=device)
    if v.numel() == 1 and v.dim() <= 1:
        return v.reshape(()).expand(pack * co)
    if v.numel() == co:
        return v.reshape(co).repeat(pack)
    if v.numel() == pack * co:
        return v.reshape(pack * co)
    raise ValueError(f"epilogue term of shape {tuple(v.shape)} is neither a "
                     f"scalar, [{co}] nor [{pack * co}]")


def conv3d_packed_s1_plain(xp, kernel, scale=1.0, bias=0.0, pack=4,
                           relu=False):
    """Plain PyTorch version: xp [B, R, H, W, pack*Ci] float32 or bfloat16,
    kernel [3, 3, 3, Ci, Co] -> [B, R, H, W, pack*Co] in xp.dtype (kernel
    rounded to xp.dtype, float32 sums and epilogue, one rounding)."""
    co = kernel.shape[-1]
    ones = kernel.new_ones(co, dtype=torch.float32)
    y = conv3d_plain(unpack_volume(xp, pack), kernel.to(xp.dtype), ones,
                     0 * ones, False)
    y = pack_volume(y, pack) * full_epilogue(scale, pack, co, xp.device) \
        + full_epilogue(bias, pack, co, xp.device)
    return (y.clamp_min(0.0) if relu else y).to(xp.dtype)


def _checked(name, xp, kernel, scale, bias, pack):
    """Check the operands of a launch; returns (kernel in xp.dtype, scale,
    bias) as the kernel takes them."""
    cin, co = kernel.shape[-2:]
    if xp.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {xp.device}")
    if (xp.dim() != 5 or xp.shape[-1] != pack * cin
            or tuple(kernel.shape) != (3, 3, 3, cin, co)):
        raise ValueError(f"{name}: xp {tuple(xp.shape)} and kernel "
                         f"{tuple(kernel.shape)} are not [B,R,H,W,{pack}*Ci] "
                         "and [3,3,3,Ci,Co]")
    if cin % 4 or co % 4:
        raise ValueError(f"{name}: Cin {cin} and Cout {co} must be multiples "
                         "of 4 (4-value vector loads)")
    if xp.dtype not in _TYPES or kernel.dtype not in _TYPES:
        raise ValueError(f"{name}: xp and kernel must be float32 or "
                         f"bfloat16, not {xp.dtype} and {kernel.dtype}")
    kernel = kernel.to(xp.dtype)
    scale, bias = scale.contiguous(), bias.contiguous()
    for t in (xp, kernel, scale, bias):
        if t.device != xp.device:
            raise ValueError(f"{name}: all operands must be on {xp.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and "
                             "16-byte aligned")
    b, r = xp.shape[:2]
    if b * r * pack > 65535 or xp.numel() >= 2 ** 31 \
            or xp.numel() // cin * co >= 2 ** 31:
        raise ValueError(f"{name}: volume {tuple(xp.shape)} too large")
    return kernel, scale, bias


def _launch(wrapper, xp, kernel, scale, bias, pack, relu):
    """Launch ``wrapper``'s kernel on checked operands; counts the launch on
    ``wrapper``."""
    b, r, h, w, _ = xp.shape
    cin, cout = kernel.shape[-2:]
    out = torch.empty((b, r, h, w, pack * cout), dtype=xp.dtype,
                      device=xp.device)
    if out.numel() == 0:
        return out
    library, prefix = _LIBRARIES[wrapper.__name__]
    symbol = f"{prefix}_{_TYPES[xp.dtype]}"
    lib = _build.load(library, {f"{prefix}_{t}": _SIGNATURE
                                for t in _TYPES.values()})
    err = getattr(lib, symbol)(
        xp.data_ptr(), kernel.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b, r, pack, h, w, cin, cout, int(bool(relu)),
        _build.current_stream())
    _build.check_launch(err, wrapper.__name__)
    wrapper.launches += 1
    return out


class _PackedConv3dS1(torch.autograd.Function):
    """Forward: the kernel. Backward: the VJP of the plain conv (cuDNN on
    the unpacked view) through the epilogue and ReLU; for a unit scale and
    no ReLU, the two cuDNN gradient convolutions alone."""

    @staticmethod
    def forward(ctx, xp, kernel, scale, bias, pack, relu, unit_scale):
        out = _launch(conv3d_packed_s1, xp, kernel, scale, bias, pack, relu)
        ctx.pack, ctx.relu, ctx.unit_scale = pack, relu, unit_scale
        ctx.save_for_backward(xp, kernel, scale, out if relu else None)
        return out

    @staticmethod
    def backward(ctx, g):
        xp, kernel, scale, out = ctx.saved_tensors
        pack = ctx.pack
        need_x, need_k, need_s, need_b = ctx.needs_input_grad[:4]
        if ctx.relu:
            g = g * (out > 0)
        g32 = g.float()     # the epilogue's terms, in float32 as its forward
        sums = tuple(range(g.dim() - 1))
        grad_x = grad_k = grad_s = grad_b = None
        if need_b:
            grad_b = g32.sum(sums)
        # logical NCDHW views of the NDHWC volumes (channels_last_3d storage)
        x = unpack_volume(xp, pack).movedim(-1, 1)
        weight = kernel.permute(4, 3, 0, 1, 2).contiguous()
        if need_x or need_k:
            g_conv = unpack_volume(
                g if ctx.unit_scale else (g32 * scale).to(g.dtype),
                pack).movedim(-1, 1)
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g_conv, x, weight, None, [1, 1, 1], [1, 1, 1], [1, 1, 1],
                False, [0, 0, 0], 1, [need_x, need_k, False])
            if need_x:
                grad_x = pack_volume(gx.movedim(1, -1), pack).contiguous()
            if need_k:
                grad_k = gw.permute(2, 3, 4, 1, 0)
        if need_s:
            raw = F.conv3d(x, weight, padding=1).movedim(1, -1)
            grad_s = (g32 * pack_volume(raw, pack).float()).sum(sums)
        return grad_x, grad_k, grad_s, grad_b, None, None, None


def conv3d_packed_s1(xp, kernel, scale=1.0, bias=0.0, pack=4, relu=False):
    """Stride-1 3x3x3 SAME conv (+scale/bias/ReLU) on a packed volume (K4).

    Args:
      xp: [B, R, H, W, pack*Ci] float32 or bfloat16, contiguous
        (``pack_volume`` layout; pack 1 is plain NDHWC).
      kernel: [3, 3, 3, Ci, Co] true (unpacked) kernel, float32 or
        bfloat16; rounded to xp.dtype.
      scale, bias: scalar, [Co] or [pack*Co] epilogue, float32.
      relu: apply max(0, .) after the epilogue.

    Returns [B, R, H, W, pack*Co] in xp.dtype, differentiable in xp, kernel,
    scale and bias. A CPU tensor runs ``conv3d_packed_s1_plain``; a CUDA
    tensor launches the kernel or raises.
    """
    co = kernel.shape[-1]
    unit_scale = isinstance(scale, (int, float)) and scale == 1
    scale = full_epilogue(scale, pack, co, xp.device)
    bias = full_epilogue(bias, pack, co, xp.device)
    if xp.device.type == "cpu":
        return conv3d_packed_s1_plain(xp, kernel, scale, bias, pack, relu)
    kernel, scale, bias = _checked("conv3d_packed_s1", xp, kernel, scale,
                                   bias, pack)
    return _PackedConv3dS1.apply(xp, kernel, scale, bias, pack, relu,
                                 unit_scale)


def conv3d_packed_s1_v2(xp, kernel, scale=1.0, bias=0.0, pack=4,
                        relu=False):
    """K5: the function of ``conv3d_packed_s1``, forward only.

    Same arguments and result as ``conv3d_packed_s1``. JAX's
    ``conv3d_packed_s1_pallas_v2`` has no VJP, so with grad mode on and an
    operand that requires grad this raises, on every device, rather than
    return a result without a gradient. A CPU tensor runs
    ``conv3d_packed_s1_plain``; a CUDA tensor launches the kernel or raises.
    """
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (xp, kernel, scale, bias)):
        raise RuntimeError("conv3d_packed_s1_v2 is forward only (no VJP, as "
                           "JAX's conv3d_packed_s1_pallas_v2); differentiate "
                           "through conv3d_packed_s1")
    co = kernel.shape[-1]
    scale = full_epilogue(scale, pack, co, xp.device)
    bias = full_epilogue(bias, pack, co, xp.device)
    if xp.device.type == "cpu":
        return conv3d_packed_s1_plain(xp, kernel, scale, bias, pack, relu)
    kernel, scale, bias = _checked("conv3d_packed_s1_v2", xp, kernel, scale,
                                   bias, pack)
    return _launch(conv3d_packed_s1_v2, xp, kernel, scale, bias, pack, relu)


conv3d_packed_s1.launches = 0
conv3d_packed_s1_v2.launches = 0
