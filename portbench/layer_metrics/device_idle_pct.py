"""The share of the traced part of the window in which no device
operation ran (100 minus the union of the device intervals over the
window), percent."""


def read(obs):
    if not obs["window_s"]:
        return None
    return 100.0 * (1.0 - obs["busy_s"] / obs["window_s"])
