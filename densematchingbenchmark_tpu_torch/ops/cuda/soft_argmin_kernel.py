"""Fused softmax-expectation disparity regression (soft-argmin) and its
gradient, Triton.

Replaces the TPU kernel densematchingbenchmark_tpu/ops/pallas/
soft_argmin_kernel.py::fused_soft_argmin (body ``_kernel``):
[B, D, H, W] cost -> [B, H, W, 1], the expectation of the sample values
under softmax(alpha * cost) over D. It is the DispPredictor of PSMNet, 3
launches per forward at [1, 192, 384, 1248] in eval and at
[3, 192, 256, 512] in training. The TPU package has no backward kernel (JAX
trains through the plain ops/soft_argmin.py); the port adds one, 3 launches
per train step:

    grad_cost[b, d, h, w] = g[b, h, w] * alpha * p_d * (v_d - E[b, h, w])

with p = softmax(alpha * cost) over d and E the forward's output.

What bounds both on an H100: device-memory bytes. Each cost value is read
once and used for one exp and a few multiply-adds, so the volume at
3.35 TB/s is the floor (0.11 ms for the 370 MB eval volume; the backward
reads and writes 302 MB each at the training shape, 0.18 ms); the
arithmetic is a few us at the f32 rate.

What the design does about it: each kernel reads the volume exactly once,
in coalesced rows. A program owns one (b, y) row and a block of W columns,
so neighbouring lanes load neighbouring W addresses, and it walks D in
chunks. The forward keeps an online (running-max) softmax, i.e. the
running max m, sum l and weighted sum per column in registers, and also
stores m and l per pixel ([B, H, W], 1/D of the volume), so that the
backward recomputes p_d = exp(alpha * c_d - m) / l from one read of the
cost and writes the gradient once: two passes over the volume in all, the
least a backward that does not keep the probabilities can do. The [D]
sample values come in as a tensor, as ``vals_ref`` does on the TPU,
because they are a linspace and not start + i * dilation when
dilation > 1. There is no H % 8 condition.

``soft_argmin_plain`` is the same function in plain PyTorch; its autograd
is the backward's plain version.
"""

import os

import torch

from ..cost_volume import disp_sample_values
from . import _build

BLOCK_D = 32
BLOCK_W = 128


def soft_argmin_plain(cost_volume, vals, alpha=1.0):
    """[B, D, H, W] cost, [D] sample values -> [B, H, W, 1] float32."""
    prob = torch.softmax(cost_volume.float() * alpha, dim=1)
    return (prob * vals.reshape(1, -1, 1, 1)).sum(dim=1)[..., None]


# triton.language, bound at the first launch (``_triton_kernels``) so that
# importing this module needs no triton: the CPU tests import it. The kernel
# below is a module-level function so that Triton resolves ``tl`` among its
# globals; it is compiled at its first launch, after ``tl`` is bound.
tl = None
_kernels = None


def _soft_argmin_kernel(cost_ptr, vals_ptr, out_ptr, m_ptr, l_ptr, D, H, W,
                        alpha, BLOCK_D: "tl.constexpr",
                        BLOCK_W: "tl.constexpr"):
    pid_w = tl.program_id(0)
    y = tl.program_id(1)
    b = tl.program_id(2).to(tl.int64)
    plane = H * W
    offs_w = pid_w * BLOCK_W + tl.arange(0, BLOCK_W)
    wmask = offs_w < W
    row = cost_ptr + b * D * plane + y * W
    m = tl.full((BLOCK_W,), float("-inf"), tl.float32)
    l = tl.zeros((BLOCK_W,), tl.float32)
    s = tl.zeros((BLOCK_W,), tl.float32)
    for d0 in range(0, D, BLOCK_D):
        offs_d = d0 + tl.arange(0, BLOCK_D)
        dmask = offs_d < D
        c = tl.load(row + offs_d[:, None] * plane + offs_w[None, :],
                    mask=dmask[:, None] & wmask[None, :], other=0.0)
        c = tl.where(dmask[:, None], c.to(tl.float32) * alpha, float("-inf"))
        v = tl.load(vals_ptr + offs_d, mask=dmask, other=0.0)
        m_new = tl.maximum(m, tl.max(c, axis=0))
        r = tl.exp(m - m_new)
        e = tl.exp(c - m_new[None, :])
        l = l * r + tl.sum(e, axis=0)
        s = s * r + tl.sum(e * v[:, None], axis=0)
        m = m_new
    pix = b * plane + y * W + offs_w
    tl.store(out_ptr + pix, s / l, mask=wmask)
    tl.store(m_ptr + pix, m, mask=wmask)
    tl.store(l_ptr + pix, l, mask=wmask)


def _soft_argmin_backward_kernel(cost_ptr, vals_ptr, out_ptr, m_ptr, l_ptr,
                                 g_ptr, grad_ptr, D, H, W, alpha,
                                 BLOCK_D: "tl.constexpr",
                                 BLOCK_W: "tl.constexpr"):
    pid_w = tl.program_id(0)
    y = tl.program_id(1)
    b = tl.program_id(2).to(tl.int64)
    plane = H * W
    offs_w = pid_w * BLOCK_W + tl.arange(0, BLOCK_W)
    wmask = offs_w < W
    pix = b * plane + y * W + offs_w
    m = tl.load(m_ptr + pix, mask=wmask, other=0.0)
    l = tl.load(l_ptr + pix, mask=wmask, other=1.0)
    e = tl.load(out_ptr + pix, mask=wmask, other=0.0)
    coef = tl.load(g_ptr + pix, mask=wmask, other=0.0) * alpha / l
    start = b * D * plane + y * W
    for d0 in range(0, D, BLOCK_D):
        offs_d = d0 + tl.arange(0, BLOCK_D)
        dmask = offs_d < D
        mask = dmask[:, None] & wmask[None, :]
        offs = start + offs_d[:, None] * plane + offs_w[None, :]
        c = tl.load(cost_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        v = tl.load(vals_ptr + offs_d, mask=dmask, other=0.0)
        p = tl.exp(c * alpha - m[None, :])
        grad = coef[None, :] * p * (v[:, None] - e[None, :])
        tl.store(grad_ptr + offs, grad.to(grad_ptr.dtype.element_ty),
                 mask=mask)


def _triton_kernels():
    """(triton, forward kernel, backward kernel), imported and wrapped at
    first use."""
    global tl, _kernels
    if _kernels is None:
        os.environ.setdefault("TRITON_CACHE_DIR",
                              str(_build.BUILD_DIR / "triton"))
        import triton
        import triton.language

        tl = triton.language
        _kernels = (triton, triton.jit(_soft_argmin_kernel),
                    triton.jit(_soft_argmin_backward_kernel))
    return _kernels


def _check(cost_volume, d, what):
    """Raise unless ``cost_volume`` is [B, d, H, W] and, off the CPU, a
    contiguous float32 / bfloat16 CUDA tensor within the launch limits."""
    if cost_volume.dim() != 4 or cost_volume.shape[1] != d:
        raise ValueError(f"{what}: cost {tuple(cost_volume.shape)} is not "
                         f"[B, {d}, H, W]")
    if cost_volume.device.type == "cpu":
        return
    if cost_volume.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {cost_volume.device}")
    if cost_volume.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: dtype {cost_volume.dtype}")
    if not cost_volume.is_contiguous():
        raise ValueError(f"{what}: cost volume must be contiguous")
    b, d, h, w = cost_volume.shape
    if h > 65535 or b > 65535 or d * h * w >= 2 ** 31:
        raise ValueError(f"{what}: {tuple(cost_volume.shape)} too large")


def _forward(cost_volume, vals, alpha):
    """Launch the forward: -> (out [B, H, W, 1], m [B, H, W], l [B, H, W])
    float32, m and l the per-pixel softmax max and sum of alpha * cost."""
    b, d, h, w = cost_volume.shape
    out, m, l = (torch.empty(shape, dtype=torch.float32,
                             device=cost_volume.device)
                 for shape in ((b, h, w, 1), (b, h, w), (b, h, w)))
    if out.numel() == 0:
        return out, m, l
    triton, kernel, _ = _triton_kernels()
    grid = (triton.cdiv(w, BLOCK_W), h, b)
    kernel[grid](cost_volume, vals, out, m, l, d, h, w, float(alpha),
                 BLOCK_D=BLOCK_D, BLOCK_W=BLOCK_W, num_warps=4)
    # Triton's launcher checks the CUresult of the launch and raises on a
    # nonzero code, so there is no separate error check here.
    fused_soft_argmin.launches += 1
    return out, m, l


def fused_soft_argmin_backward(cost_volume, vals, alpha, out, m, l, grad):
    """Gradient of the soft-argmin with respect to the cost, from the
    forward's ``out`` [B, H, W, 1], ``m`` and ``l`` [B, H, W] and the
    output gradient ``grad`` [B, H, W, 1]: -> [B, D, H, W] in the cost's
    dtype. Launches the Triton kernel (CUDA tensors only) or raises."""
    if cost_volume.device.type != "cuda":
        raise ValueError(f"fused_soft_argmin_backward: unsupported device "
                         f"{cost_volume.device}")
    _check(cost_volume, len(vals), "fused_soft_argmin_backward")
    b, d, h, w = cost_volume.shape
    grad = grad.to(torch.float32).contiguous()
    if grad.numel() != b * h * w:
        raise ValueError(f"fused_soft_argmin_backward: grad "
                         f"{tuple(grad.shape)} is not [{b}, {h}, {w}, 1]")
    grad_cost = torch.empty_like(cost_volume)
    if grad_cost.numel() == 0:
        return grad_cost
    triton, _, kernel = _triton_kernels()
    grid = (triton.cdiv(w, BLOCK_W), h, b)
    kernel[grid](cost_volume, vals, out, m, l, grad, grad_cost, d, h, w,
                 float(alpha), BLOCK_D=BLOCK_D, BLOCK_W=BLOCK_W,
                 num_warps=4)
    fused_soft_argmin_backward.launches += 1
    return grad_cost


class _FusedSoftArgmin(torch.autograd.Function):
    """Forward and backward are the Triton kernels; the forward's per-pixel
    max and sum are kept for the backward."""

    @staticmethod
    def forward(ctx, cost_volume, vals, alpha):
        out, m, l = _forward(cost_volume, vals, alpha)
        ctx.save_for_backward(cost_volume, vals, out)
        ctx.stats, ctx.alpha = (m, l), alpha
        return out

    @staticmethod
    def backward(ctx, grad):
        cost_volume, vals, out = ctx.saved_tensors
        grad_cost = fused_soft_argmin_backward(cost_volume, vals, ctx.alpha,
                                               out, *ctx.stats, grad)
        return grad_cost, None, None


def fused_soft_argmin(cost_volume, max_disp, start_disp=0, dilation=1,
                      alpha=1.0):
    """[B, D, H, W] cost -> [B, H, W, 1] float32 disparity, with the
    uniform-range samples ``disp_sample_values(max_disp, start_disp,
    dilation)``, differentiable in the cost. A CPU tensor runs
    ``soft_argmin_plain`` (plain autograd); a CUDA tensor launches the
    Triton kernels (forward here, backward in the backward pass) or
    raises."""
    vals = torch.as_tensor(disp_sample_values(max_disp, start_disp, dilation),
                           device=cost_volume.device)
    _check(cost_volume, len(vals), "fused_soft_argmin")
    if cost_volume.device.type == "cpu":
        return soft_argmin_plain(cost_volume, vals, alpha)
    return _FusedSoftArgmin.apply(cost_volume, vals, alpha)


fused_soft_argmin.launches = 0
fused_soft_argmin_backward.launches = 0
