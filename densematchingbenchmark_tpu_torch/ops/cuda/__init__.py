"""Kernels written by hand for Hopper (sm_90a), the counterparts of the
Pallas TPU kernels in densematchingbenchmark_tpu/ops/pallas/.

Each module holds a wrapper with a launch counter (``<wrapper>.launches``,
incremented only where the kernel is launched; K4 and K5 also count their
bfloat16 launches, ``<wrapper>.bf16_launches``) and the plain PyTorch
version of the same function, which the wrapper runs for CPU tensors.
CUDA C++ sources live in ``densematchingbenchmark_tpu_torch/csrc/`` and are
built at first use (``_build``); the Triton kernels are compiled at their
first launch. Nothing here imports triton or needs nvcc at import time.
"""

from .conv3d_kernel import conv3d_plain, fused_conv3d
from .packed_conv3d_kernel import (conv3d_packed_s1, conv3d_packed_s1_plain,
                                   conv3d_packed_s1_v2)
from .soft_argmin_kernel import (fused_soft_argmin,
                                 fused_soft_argmin_backward,
                                 soft_argmin_plain)
from .upsample_argmin_kernel import (fused_upsample_soft_argmin,
                                     upsample_soft_argmin_plain)

KERNELS = (fused_conv3d, fused_soft_argmin, fused_soft_argmin_backward,
           fused_upsample_soft_argmin, conv3d_packed_s1, conv3d_packed_s1_v2)
# the wrappers with a bfloat16 route of their own (the tensor cores)
BF16_KERNELS = (conv3d_packed_s1, conv3d_packed_s1_v2)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
    for k in BF16_KERNELS:
        k.bf16_launches = 0


def launch_counts():
    return {k.__name__: k.launches for k in KERNELS}


def bf16_launch_counts():
    """The bfloat16 launches, a part of ``launch_counts()``'s."""
    return {k.__name__: k.bf16_launches for k in BF16_KERNELS}


__all__ = ["conv3d_plain", "fused_conv3d", "conv3d_packed_s1",
           "conv3d_packed_s1_plain", "conv3d_packed_s1_v2", "fused_soft_argmin",
           "fused_soft_argmin_backward", "soft_argmin_plain",
           "fused_upsample_soft_argmin", "upsample_soft_argmin_plain",
           "KERNELS", "BF16_KERNELS", "reset_launch_counts", "launch_counts",
           "bf16_launch_counts"]
