"""Host ms a call beyond the device's busy time: the call's wall time
minus its device time (the profiler's union of device intervals), over
the traced part of the window."""


def read(obs):
    if not obs["calls"]:
        return None
    return (obs["window_s"] - obs["busy_s"]) / obs["calls"] * 1e3
