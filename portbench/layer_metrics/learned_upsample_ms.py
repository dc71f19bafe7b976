"""Device ms a frame of the convolutions whose weight is [1, 1, 8, 8, 8]:
AcfNet's three learned ConvTranspose3d(1, 1, 8, stride 4) upsamplers,
their kernels included (the profiler's aten::convolution device time)."""

WEIGHT = [1, 1, 8, 8, 8]


def read(obs):
    ms = sum(s for _, shapes, s in obs["conv_ops"] if WEIGHT in shapes[1:3])
    if not ms or not obs["frames"]:
        return None
    return ms / obs["frames"] * 1e3
