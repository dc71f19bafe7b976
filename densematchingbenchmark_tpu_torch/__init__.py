"""densematchingbenchmark_tpu_torch: the PyTorch + CUDA port of
densematchingbenchmark_tpu for NVIDIA Hopper GPUs (H100).

The JAX package beside it is the reference this port is held against; the
port imports none of it. Each module mirrors the file of the same name in
the JAX package. Public functions keep the JAX layouts so the two can be
compared like with like:

  image / feature map   [B, H, W, C]
  cost volume (raw)     [B, D, H, W, C]   NDHWC contiguous (channels_last_3d
                                          storage of a logical NCDHW tensor)
  cost volume (scored)  [B, D, H, W]
  disparity map         [B, H, W, 1]
  flow field            [B, H, W, 2]      (u, v) in pixels

Every Pallas TPU kernel on a ported path is a kernel written by hand for
Hopper under ``ops/cuda/`` (sources in ``csrc/``), with a plain PyTorch
version beside it. A wrapper given a CPU tensor runs the plain version; given
a CUDA tensor it launches the kernel or raises.

Entry points (``apis.init_model``, ``apis.init_flow_model``) run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
