"""The D-packed volume layout of the 3-D trunk.

This package's own copy of densematchingbenchmark_tpu/ops/conv3d.py:208-222.
A packed volume holds ``pack`` consecutive depth slices in its channel
axis: xp[b, r, h, w, p * C + c] = x[b, r * pack + p, h, w, c]. The port's
trunk runs unpacked (pack 1); the layout is kept for the packed conv
kernel's contract (ops/cuda/packed_conv3d_kernel.py).
"""


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
