"""Kernels written by hand for Hopper (sm_90a), the counterparts of the
Pallas TPU kernels in densematchingbenchmark_tpu/ops/pallas/.

Each module holds a wrapper with a launch counter (``<wrapper>.launches``,
incremented only where the kernel is launched) and the plain PyTorch
version of the same function, which the wrapper runs for CPU tensors.
CUDA C++ sources live in ``densematchingbenchmark_tpu_torch/csrc/`` and are
built at first use (``_build``); the Triton kernels are compiled at their
first launch. Nothing here imports triton or needs nvcc at import time.
"""

from .conv3d_kernel import conv3d_plain, fused_conv3d
from .packed_conv3d_kernel import conv3d_packed_s1, conv3d_packed_s1_plain
from .soft_argmin_kernel import (fused_soft_argmin,
                                 fused_soft_argmin_backward,
                                 soft_argmin_plain)
from .upsample_argmin_kernel import (fused_upsample_soft_argmin,
                                     upsample_soft_argmin_plain)

KERNELS = (fused_conv3d, fused_soft_argmin, fused_soft_argmin_backward,
           fused_upsample_soft_argmin, conv3d_packed_s1)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


def launch_counts():
    return {k.__name__: k.launches for k in KERNELS}


__all__ = ["conv3d_plain", "fused_conv3d", "conv3d_packed_s1",
           "conv3d_packed_s1_plain", "fused_soft_argmin",
           "fused_soft_argmin_backward", "soft_argmin_plain",
           "fused_upsample_soft_argmin", "upsample_soft_argmin_plain",
           "KERNELS", "reset_launch_counts", "launch_counts"]
