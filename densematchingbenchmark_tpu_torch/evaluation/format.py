"""Eval-metric formatting: a table of disparity id x metric, and the
combination of sharded results.

Counterpart of densematchingbenchmark_tpu/evaluation/format.py:11-69: rows
are disparity ids, column groups {all, occ, noc} x {1px..5px, epe},
rendered by pandas when it is importable and as sorted 'key: value' lines
otherwise.
"""

import re

import torch

from ..parallel import collectives


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
    """Combine the ranks' (averaged metrics, sample count) into the whole
    set's, on every rank; without a process group the input unchanged.

    The ranks first agree on the union of their keys (a stride shard past
    the dataset's end has no samples and ``{}`` metrics), then each turns
    its averages into sums, one all-reduce (float64, on the host under
    gloo and on the rank's GPU under NCCL) sums the sums and the counts,
    and the sums are averaged again."""
    if not collectives.in_group():
        return avg_metrics, count
    keys = sorted(set().union(*collectives.all_gather_object(
        sorted(avg_metrics))))
    vec = torch.tensor([avg_metrics.get(k, 0.0) * count for k in keys]
                       + [count], dtype=torch.float64,
                       device=collectives.collective_device())
    total = collectives.all_reduce_(vec).tolist()
    n = max(total[-1], 1.0)
    return {k: v / n for k, v in zip(keys, total[:-1])}, int(total[-1])
