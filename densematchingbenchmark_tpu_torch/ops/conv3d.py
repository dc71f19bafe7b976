"""The D-packed volume layout of the 3-D trunk.

This package's own copy of densematchingbenchmark_tpu/ops/conv3d.py:118-145
and :208-222. A packed volume holds ``pack`` consecutive depth slices in its
channel axis: xp[b, r, h, w, p * C + c] = x[b, r * pack + p, h, w, c]. The
port's trunk runs unpacked (pack 1); the layout is kept for the packed conv
kernels' contract (ops/cuda/packed_conv3d_kernel.py) and the packed-conv
microbench (tools/microbench_packed.py), whose dense-packed baseline convolves
a packed volume with ``dpack_kernel``.
"""


def _dpack_blocks(pack):
    """Valid (tap index tj + 1, input slot p, output slot q, depth tap td).

    From x depth index P*(j+tj)+p == output depth P*j+q shifted by td-1:
    td = P*tj + p - q + 1, kept when td lands in {0, 1, 2}.
    """
    return tuple((tj + 1, p, q, pack * tj + p - q + 1)
                 for tj in (-1, 0, 1) for p in range(pack)
                 for q in range(pack) if 0 <= pack * tj + p - q + 1 <= 2)


def dpack_kernel(kernel, pack):
    """[3, kh, kw, Ci, Co] -> block-sparse packed [3, kh, kw, P*Ci, P*Co].

    A stride-1, padding-1 conv of a packed volume with this kernel is the
    true conv, packed; the zero blocks are MACs that the dense packed form
    does and the true one does not (3/4 of them at pack 4).
    """
    _, kh, kw, ci, co = kernel.shape
    kp = kernel.new_zeros((3, kh, kw, pack * ci, pack * co))
    for tj, p, q, td in _dpack_blocks(pack):
        kp[tj, :, :, p * ci:(p + 1) * ci, q * co:(q + 1) * co] = kernel[td]
    return kp


def pack_volume(x, pack):
    """[B, D, H, W, C] -> packed [B, D/pack, H, W, pack*C]."""
    b, d, h, w, c = x.shape
    if d % pack:
        raise ValueError(f"pack_volume: depth {d} is not a multiple of "
                         f"pack {pack}")
    xp = x.reshape(b, d // pack, pack, h, w, c).movedim(2, 4)
    return xp.reshape(b, d // pack, h, w, pack * c)


def unpack_volume(xp, pack):
    """Packed [B, R, H, W, pack*C] -> [B, R*pack, H, W, C]."""
    b, r, h, w, pc = xp.shape
    if pc % pack:
        raise ValueError(f"unpack_volume: {pc} channels are not a multiple "
                         f"of pack {pack}")
    x = xp.reshape(b, r, h, w, pack, pc // pack).movedim(4, 2)
    return x.reshape(b, r * pack, h, w, pc // pack)
