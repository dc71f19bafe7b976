"""The benchmark's own tests: ``python -m pytest portbench/tests`` (the
card's with ``-m cuda``, on a machine with one)."""
