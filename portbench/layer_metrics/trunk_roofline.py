"""The trunk units' least time (roofline.trunk_call_bound_s of each call
the hooks saw) over the device time of the kernels that carry them
(names holding roofline.TRUNK_KERNEL), in percent; nothing where no such
kernel ran."""

from portbench import roofline


def read(obs):
    kernel_s = sum(s for name, s, _ in obs["kernels"]
                   if obs["trunk_kernel"] in name)
    if not kernel_s or not obs["trunk_calls"]:
        return None
    return roofline.trunk_bound_s(obs["trunk_calls"]) / kernel_s * 100.0
