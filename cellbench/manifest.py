"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (``configs/<config>.json``), its traffic mix
(``mixes/<traffic>.json``) and each per-layer metric's reader
(``metrics/<name>.py``, a function ``read(view)`` that returns a number or
None)."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json; there are "
                     f"{[w['name'] for w in bench['workloads']]}")


def config(name: str) -> dict:
    return load_json(os.path.join(HERE, "configs", name + ".json"))


def mix(name: str) -> dict:
    return load_json(os.path.join(HERE, "mixes", name + ".json"))


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("cellbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: dict, section: str, cell: str) -> list:
    """The section's metrics that the cell reports: those whose
    ``workloads`` list names it, or that have no such list."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]
