"""A cell at a size that a CPU test run holds: the cell's configuration
with the port's small overrides (``TINY_OVERRIDES`` of
``f2nerf_torch.utils.synthetic``: a 4,096-sample batch, a shallow tree, a
2^12 table), 40x60 images and a short settle. Only the tests under
``cellbench/`` use it; the benchmark runs the files as they are."""

from __future__ import annotations

import copy
import os

from . import manifest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_cell(cell: str) -> tuple[dict, dict, dict]:
    """(BENCHMARK.json, the cell's configuration file, its mix), cut down."""
    bench = manifest.benchmark(ROOT)
    w = manifest.workload(bench, cell)
    return (bench,) + tiny_pair(w["config"], w["traffic"])


def tiny_pair(config: str, traffic: str) -> tuple[dict, dict]:
    """(a configuration file, a traffic mix), cut down: also a pair that
    no cell of BENCHMARK.json runs."""
    from f2nerf_torch.utils.config import apply_override
    from f2nerf_torch.utils.synthetic import TINY_OVERRIDES
    doc = copy.deepcopy(manifest.config(config))
    for ov in TINY_OVERRIDES:
        apply_override(doc["config"], ov)
    mix = manifest.mix(traffic)
    mix.update(image_hw=[40, 60], settle=dict(min_steps=10, max_steps=30, stable_chunks=1),
               check_rays=256)
    return doc, mix
