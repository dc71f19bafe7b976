"""Seconds from the run's start to its window: imports, kernel builds and
loads, the model, the seeded weights and data, the warm-up."""


def read(record):
    return record["setup_s"]
