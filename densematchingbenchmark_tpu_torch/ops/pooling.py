"""Average pooling for the SPP branches.

Counterpart of densematchingbenchmark_tpu/ops/pooling.py:35-48.
"""


def avg_pool2d(x, window, stride=None):
    """[B, H, W, C] average pool with window == stride, floor-cropped.

    Matches nn.AvgPool2d((k, k), stride=(k, k)) on the channels-last map:
    rows and columns beyond the last whole window are dropped.
    """
    if stride is None:
        stride = window
    if window != stride:
        raise NotImplementedError("only window == stride pooling is used")
    b, h, w, c = x.shape
    out_h, out_w = h // stride, w // stride
    x = x[:, :out_h * stride, :out_w * stride, :]
    return x.reshape(b, out_h, stride, out_w, stride, c).mean(dim=(2, 4))
