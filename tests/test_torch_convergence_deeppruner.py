"""JAX's CPU convergence criterion for DeepPruner-4x (its quantile loss
through PatchMatch), met by the port's tools/convergence_gauntlet.py from
JAX's initial weights at JAX's CI sizes: the case and its set-up are
tests/test_torch_convergence_overfit.py's.
"""

import torch

from test_torch_convergence_overfit import DROP, run_from_jax_init

# The suite runs several test workers on one CPU: one torch intra-op
# thread each keeps their OpenMP pools from oversubscribing the cores.
torch.set_num_threads(1)


def test_deeppruner_4x_meets_jax_criterion(monkeypatch):
    r = run_from_jax_init(monkeypatch, "DeepPruner-4x")
    assert [s for s, _ in r["losses"]] == [1, 4, 8, 12, 16, 20, 24]
    assert r["loss_last"] < DROP * r["loss_first"], r
    assert r["epe_final"] < r["epe_init"], r
