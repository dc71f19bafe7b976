"""Sparsification plot: confidence quality as EPE against removal.

Counterpart of densematchingbenchmark_tpu/evaluation/sparsification.py:
13-61 (numpy; it runs on evaluation results, not on the device). Removing
the least-confident X % of the valid pixels and measuring the EPE of the
rest, against the oracle (remove the largest errors first) and a random
order: a good confidence estimate tracks the oracle.
"""

import numpy as np


def _norm(x):
    rng = x.max() - x.min()
    x = x / (rng if rng > 0 else 1.0)
    return x * 0.9 + 0.05


def sparsification_plot(est_disp, gt_disp, est_conf, bins=10, lb=None,
                        ub=None, seed=0):
    """{'est_P': epe, 'oracle_P': epe, 'random_P': epe} for each removed
    percentage P in 0, 100 / bins, ..., 100 (100 stays 0.0)."""
    assert 100 % bins == 0
    est = np.asarray(est_disp, np.float64).ravel()
    gt = np.asarray(gt_disp, np.float64).ravel()
    conf = np.asarray(est_conf, np.float64).ravel()

    part = 100 // bins
    out = {f"{k}_{part * i}": 0.0 for i in range(bins + 1)
           for k in ("est", "oracle", "random")}

    mask = np.ones(gt.shape, bool)
    if lb is not None:
        mask &= gt > lb
    if ub is not None:
        mask &= gt < ub
    n_valid = int(mask.sum())
    if n_valid < bins:
        return out

    abs_error = np.abs(gt - est) * mask
    # higher = kept longer; invalid pixels below every threshold
    keys = {
        "est": np.where(mask, _norm(conf), -1.0),
        "oracle": np.where(mask, 1.0 - _norm(abs_error), -1.0),
        "random": np.where(mask, _norm(
            np.random.RandomState(seed).rand(*gt.shape)), -1.0),
    }

    n_invalid = gt.size - n_valid
    step = (n_valid - 1) // bins
    for name, key in keys.items():
        order = np.sort(key)
        for i in range(bins):
            keep = key >= order[n_invalid + step * i]
            out[f"{name}_{part * i}"] = float(
                (abs_error * keep).sum() / max(keep.sum(), 1))
    return out
