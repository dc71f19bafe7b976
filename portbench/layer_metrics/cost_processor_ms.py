"""Device ms a frame between CUDA events recorded at the cost processor's
forward pre- and post-hooks (the volume and the whole 3-D aggregator,
its upsample included), after the profiled part of the window."""


def read(obs):
    if not obs["cost_processor_calls"] or not obs["after_frames"]:
        return None
    return obs["cost_processor_s"] / obs["after_frames"] * 1e3
