"""What every run shares: the checkout's caches, the cell's files, the
card check, the JAX check and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. Its files are
found by name: ``configs/<config>.json`` (the configuration as it is
run), ``traffic/<traffic>.json`` (the mix's parameters, read by the
driver it names under ``drivers/``) and ``limits/<workload>.json`` (the
limit of each number the correctness check compares). A per-layer metric
``<name>`` is read by ``layer_metrics/<name>.py`` or, where there is no
such file, by the reader of its quantity, ``layer_metrics/<q>.py`` for a
name ``<q>.<the end-to-end metric's cells>`` (``mfu.eval``, ``mfu.infer``
read alike); an end-to-end one by ``end_to_end/<name>.py``. Each defines
``read(record)`` and returns a number, or None where its run gave it
nothing to read.
"""

import importlib.util
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the top-level modules that no run may load: the JAX stack and the JAX
# package the port was made from (compared whole: the port's own name
# begins with the latter)
FORBIDDEN = ("jax", "jaxlib", "flax", "densematchingbenchmark_tpu")


def set_caches():
    """Every build and kernel cache inside the checkout, at fixed paths:
    the port builds its nvcc and g++ libraries under its package's
    ``_build/``; Triton's compiled kernels go to ``_build/triton`` there
    too, set here before anything imports Triton."""
    build = ROOT / "densematchingbenchmark_tpu_torch" / "_build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def read_json(path):
    with open(path) as fp:
        return json.load(fp)


def spec():
    return read_json(ROOT / "BENCHMARK.json")


def cell_files(bench, workload):
    """(cell, config, traffic, limits) of ``workload``."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; BENCHMARK.json has "
                       f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(ROOT / configs[cell["config"]]["file"])
    traffic = read_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = read_json(HERE / "limits" / f"{workload}.json")
    return cell, config, traffic, limits


def cell_metrics(bench, workload, kind):
    """The ``kind`` ('end_to_end' or 'per_layer') metrics this cell
    reports: those that list it, and those with no list whose ``moves``
    (a per-layer metric's) this cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if kind == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])
            and m["moves"] in moved]


def reader(kind, name):
    """``read`` of ``<kind>/<name>.py``, else of ``<kind>/<q>.py`` for
    ``name`` '<q>.<suffix>', loaded by path (a metric's name may hold
    dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        path = HERE / kind / f"{name.split('.')[0]}.py"
    mod_name = f"portbench.{kind}.{path.stem.replace('.', '__')}"
    loaded = sys.modules.get(mod_name)
    if loaded is None:
        spec_ = importlib.util.spec_from_file_location(mod_name, path)
        loaded = importlib.util.module_from_spec(spec_)
        spec_.loader.exec_module(loaded)
        sys.modules[mod_name] = loaded
    return loaded.read


def driver(name):
    return importlib.import_module(f"portbench.drivers.{name}")


def card(chips):
    """Exits non-zero with no result where CUDA is missing or fewer cards
    than the cell asks for are present."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("portbench: no CUDA device; the benchmark measures the "
                 "port on the card and has no CPU fallback")
    count = torch.cuda.device_count()
    if count < chips:
        sys.exit(f"portbench: the cell needs {chips} cards, "
                 f"{count} present")


def forbidden_modules():
    """The forbidden top-level names that ``sys.modules`` holds."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def emit(result, checks):
    """The compared numbers beside their limits as the last lines of
    standard error, then the result line, ``checks`` last in it, as the
    last line of standard output."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    out = dict(result)
    out["checks"] = checks
    print(json.dumps(out), flush=True)
