"""The benchmark of the PyTorch and CUDA port (densematchingbenchmark_tpu_torch).

Run one cell: ``python3 -m portbench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of the checkout.
"""
