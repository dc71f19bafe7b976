"""The convolution FLOPs of the frames completed after the profiled part
of the window (roofline.count_flops of a frame on the reference, times
the frames whose results the host held at the part's last such point)
over the host seconds to that point, as a share of the card's bf16
dense peak, percent."""

from portbench import roofline


def read(obs):
    if not obs["after_done_frames"] or not obs["after_s"]:
        return None
    flops = obs["flops_per_frame"] * obs["after_done_frames"]
    return flops / obs["after_s"] / roofline.PEAK_BF16_FLOPS * 100
