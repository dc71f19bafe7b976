"""Host ms a sample spends in the data set's ``__getitem__`` (decode,
pad, normalize), timed by the benchmark's wrapper around the data set
after the profiled part of the window; the loader's threads overlap
them."""


def read(obs):
    loads = obs["spans"].get("sample_load")
    if not loads:
        return None
    return sum(loads) / len(loads) * 1e3
