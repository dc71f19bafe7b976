"""Kernel launches a frame in the traced part of the window (the
profiler's device events, copies and fills left out)."""


def read(obs):
    if not obs["frames"] or not obs["launches"]:
        return None
    return obs["launches"] / obs["frames"]
