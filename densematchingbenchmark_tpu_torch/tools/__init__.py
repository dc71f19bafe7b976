"""Command-line tools of the port (``python -m
densematchingbenchmark_tpu_torch.tools.<name>``)."""
