"""Frames completed over the whole measured window, per second."""


def read(record):
    return record["frames"] / record["elapsed_s"]
