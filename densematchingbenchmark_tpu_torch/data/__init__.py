"""Data helpers of the port (counterparts of densematchingbenchmark_tpu/data/)."""
