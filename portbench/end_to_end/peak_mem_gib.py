"""The card's peak of allocated memory over the window
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` at
its start), GiB."""


def read(record):
    peak = record["memory_peak_bytes"]
    return peak / 2 ** 30 if peak else None
