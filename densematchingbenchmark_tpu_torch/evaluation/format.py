"""Eval-metric formatting: a table of disparity id x metric, and the
combination of sharded results.

Counterpart of densematchingbenchmark_tpu/evaluation/format.py:11-69: rows
are disparity ids, column groups {all, occ, noc} x {1px..5px, epe},
rendered by pandas when it is importable and as sorted 'key: value' lines
otherwise.
"""

import re

import torch.distributed as dist


def metrics_table(results):
    """{'disp_0/epe': v, 'disp_0/occ_epe': ...} -> formatted string."""
    try:
        import pandas as pd
    except ImportError:
        return "\n".join(f"{k}: {v:.4f}" for k, v in sorted(results.items()))

    rows = {}
    for key, val in results.items():
        m = re.match(r"disp_(\d+)/(?:(occ|noc)_)?(\w+)", key)
        if not m:
            continue
        did, region, metric = m.groups()
        rows.setdefault(f"disp_{did}", {})[f"{region or 'all'}/{metric}"] = val
    if not rows:
        return "(no metrics)"
    df = pd.DataFrame.from_dict(rows, orient="index")
    order = sorted(df.columns, key=lambda c: (
        {"all": 0, "occ": 1, "noc": 2}[c.split("/")[0]], c))
    return df[order].round(4).to_string()


def combine_shard_metrics(avg_metrics, count):
    """Combine per-process (averaged metrics, sample count). One process
    (no process group, or a group of one): the input unchanged."""
    if not dist.is_available() or not dist.is_initialized() \
            or dist.get_world_size() == 1:
        return avg_metrics, count
    raise NotImplementedError(
        "combining eval shards across processes is not ported yet "
        "(ROADMAP.md queue 1 item 5)")
