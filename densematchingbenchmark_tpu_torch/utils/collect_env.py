"""Environment dump for reproducibility logs, and per-device memory stats.

Counterpart of densematchingbenchmark_tpu/utils/collect_env.py:12-55:
Python and the platform, torch, the CUDA runtime torch was built for,
cuDNN, ``nvcc --version`` and triton where present, numpy, and the GPU's
name and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them (a card may be set below its maximum
power, and then runs slower: every time the tools print stands beside
this line). On a machine without a GPU it says so. Nothing here raises
for a missing piece.
"""

import importlib
import platform
import shutil
import subprocess
import sys

import torch

SMI_QUERY = ("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader")


def _run(cmd):
    """The command's standard output, stripped, or None where it cannot
    run or fails."""
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def card_line():
    """'gpu: <name>, <power limit>' of each GPU (nvidia-smi's line), or
    what stands in for it: torch's device name where nvidia-smi does not
    run, and 'gpu: none' without a GPU."""
    if not torch.cuda.is_available():
        return "gpu: none (torch.cuda.is_available() is False)"
    smi = _run(SMI_QUERY)
    if smi:
        return "gpu: " + "; ".join(smi.splitlines())
    return (f"gpu: {torch.cuda.get_device_name(0)} (power limit not read: "
            "nvidia-smi did not run)")


def _nvcc():
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    out = _run([nvcc, "--version"])
    return out.splitlines()[-1] if out else None


def collect_env_info():
    """The environment as text, one item a line, the card's line first."""
    lines = [card_line(),
             f"python: {sys.version.split()[0]} ({platform.platform()})",
             f"torch: {torch.__version__}",
             f"cuda runtime (torch built for): {torch.version.cuda}",
             f"cudnn: {torch.backends.cudnn.version()}"]
    nvcc = _nvcc()
    if nvcc:
        lines.append(f"nvcc: {nvcc}")
    for name in ("triton", "numpy"):
        try:
            version = importlib.import_module(name).__version__
            lines.append(f"{name}: {version}")
        except ImportError:
            pass
    if torch.cuda.is_available():
        lines.append(f"devices: {torch.cuda.device_count()} x "
                     f"{torch.cuda.get_device_name(0)}")
    return "\n".join(lines)


def device_memory_stats():
    """{'cuda:<i>': {'allocated', 'peak_allocated', 'reserved',
    'peak_reserved'} in bytes} of every GPU that torch has initialised
    (torch.cuda.memory_stats); {} without a GPU. The counterpart of the
    JAX package's per-device bytes_in_use / peak_bytes_in_use."""
    if not torch.cuda.is_available():
        return {}
    stats = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        if not s:
            continue
        stats[f"cuda:{i}"] = {
            "allocated": s.get("allocated_bytes.all.current", 0),
            "peak_allocated": s.get("allocated_bytes.all.peak", 0),
            "reserved": s.get("reserved_bytes.all.current", 0),
            "peak_reserved": s.get("reserved_bytes.all.peak", 0)}
    return stats
