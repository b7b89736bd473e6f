"""What the port's span table costs, and the profiler's share of the host
numbers it gives, on one training cell of the benchmark, on the card.

    python3 scripts/span_cost.py --workload <cell> --seed <n> [--seconds 4] [--turns 2]

from the root of the repository. Sets the cell up once
(``cellbench.cell.Run``: scene, Trainer, weights, subdivision, settle),
collecting the span table over the set-up, then, in one process:

1. a span boundary's host cost (``Spans``, one range closed and the next
   opened), in turns: the profiler ranges alone, as ``Spans`` was before
   it kept a table; ``Spans`` with collection off; with collection on;
2. training windows of ``--seconds`` in turns (off, on, traced, traced,
   on, off, for each of ``--turns``): collection off; collection on;
   collection on under ``torch.profiler``, as a ``--trace 1`` run takes
   its window. Each gives rays/s, ms an iteration and, where collecting,
   host ms an iteration by layer (``HOST``) from the table taken between
   the window's two synchronizes.

Prints the set-up table, a line a window and one JSON line at the end:
medians by mode, the spans an iteration, and the boundary costs times
those counts in us a step.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from cellbench import manifest  # noqa: E402
from cellbench.cell import Run, sync  # noqa: E402
from f2nerf_torch.utils import spans  # noqa: E402

# host ms an iteration by layer: the spans whose totals each sums; the
# eight cover disjoint time ("unspanned": the window less the main
# thread's outermost spans)
HOST = {
    "sample_rays": ("step.sample_rays",),
    "sampler": ("render.traverse", "render.march"),
    "renderer": ("render.compact_a_warp", "render.prefilter", "render.compact_b",
                 "render.composite"),
    "field": ("render.field_shader",),
    "backward": ("step.backward",),
    "optimizer": ("step.adam", "step.occupancy_fold"),
    "wait": ("step.drain",),
    "unspanned": None,
}
# the spans the step had before the table: a range each, no table
RANGES_BEFORE = ("step.sample_rays", "step.render", "step.losses", "step.backward",
                 "step.allreduce", "step.occupancy_fold", "step.adam")


def host_ms(table: dict, seconds: float, iterations: int) -> dict:
    """Host ms an iteration by layer (``HOST``) of a window's table."""
    out = {}
    for k, names in HOST.items():
        if names is None:
            top = sum(r["top_ns"] for r in table.values()) / 1e6
            out[k] = (seconds * 1e3 - top) / iterations
        else:
            out[k] = sum(table[n]["total_ns"] for n in names if n in table) / 1e6 / iterations
    return out


class Ranges:
    """The spans as they were before the table: profiler ranges alone."""

    def __init__(self):
        self._cur = None

    def __call__(self, name: str) -> None:
        self.close()
        self._cur = torch.profiler.record_function(name)
        self._cur.__enter__()

    def close(self) -> None:
        if self._cur is not None:
            self._cur.__exit__(None, None, None)
            self._cur = None


def boundary_ns(spans, n: int = 20000, turns: int = 5) -> dict:
    """Host ns a boundary (close one range, open the next), medians of
    ``turns`` rounds of ``n`` in turns."""
    kinds = {"ranges alone": (Ranges, False), "off": (spans.Spans, False),
             "on": (spans.Spans, True)}
    got = {k: [] for k in kinds}
    for _ in range(turns):
        for k, (make, on) in kinds.items():
            was = spans.collect(on)
            s = make()
            t = time.perf_counter_ns()
            for _ in range(n):
                s("cost.a")
                s("cost.b")
            s.close()
            got[k].append((time.perf_counter_ns() - t) / (2 * n))
            spans.collect(was)
    return {k: statistics.median(v) for k, v in got.items()}


def train_window(run: Run, spans, seconds: float) -> dict:
    """``Run.train_window``'s loop, with the table taken between its two
    synchronizes (the drain after them left out)."""
    tr = run.tr
    sync(run.device)
    before = spans.snapshot()
    t0 = time.perf_counter()
    it0 = tr.iter_step
    while time.perf_counter() - t0 < seconds:
        tr.train_auto(sync=False)
    sync(run.device)
    secs = time.perf_counter() - t0
    table = spans.diff(spans.snapshot(), before)
    iters = tr.iter_step - it0
    tr.train_auto(sync=True)
    return dict(seconds=secs, iterations=iters, rays=iters * run.step_key["n_rays"],
                spans=table)


def window(run: Run, spans, mode: str, seconds: float) -> dict:
    was = spans.collect(mode != "off")
    if mode == "traced":
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            res = train_window(run, spans, seconds)
    else:
        res = train_window(run, spans, seconds)
    spans.collect(was)
    out = dict(mode=mode, rays_per_s=res["rays"] / res["seconds"],
               ms_per_iteration=1e3 * res["seconds"] / res["iterations"],
               iterations=res["iterations"])
    if mode != "off":
        out["host"] = host_ms(res["spans"], res["seconds"], res["iterations"])
        out["spans_per_iteration"] = {k: v["count"] / res["iterations"]
                                      for k, v in res["spans"].items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_cost: needs a CUDA card", file=sys.stderr)
        return 2
    bench = manifest.benchmark(os.getcwd())
    w = manifest.workload(bench, args.workload)
    cfg_doc, mix = manifest.config(w["config"]), manifest.mix(w["traffic"])
    if mix["mode"] != "train":
        print("span_cost: a training cell", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="span_cost_")
    try:
        run = Run(cfg_doc, mix, args.seed, "cuda:0", tmp)
        was = spans.collect(True)
        run.setup()
        spans.collect(was)
        print("[span_cost] set-up table (host ns): " + json.dumps(spans.snapshot()),
              flush=True)
        bound = boundary_ns(spans)
        print("[span_cost] boundary ns: " + json.dumps(bound), flush=True)
        rows = []
        for _ in range(args.turns):
            for mode in ("off", "on", "traced", "traced", "on", "off"):
                rows.append(window(run, spans, mode, args.seconds))
                print("[span_cost] " + json.dumps(rows[-1]), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    med = {}
    for mode in ("off", "on", "traced"):
        rs = [r for r in rows if r["mode"] == mode]
        med[mode] = dict(rays_per_s=statistics.median(r["rays_per_s"] for r in rs),
                         ms_per_iteration=statistics.median(r["ms_per_iteration"] for r in rs))
        if mode != "off":
            med[mode]["host"] = {m: statistics.median(r["host"][m] for r in rs) for m in HOST}
    per_it = {k: statistics.median(r["spans_per_iteration"].get(k, 0.0) for r in rows
                                   if r["mode"] == "on")
              for k in rows[1]["spans_per_iteration"]}
    before = sum(v for k, v in per_it.items() if k.startswith("render.") or k in RANGES_BEFORE)
    added = sum(per_it.values()) - before
    out = dict(
        workload=args.workload, seed=args.seed, card=torch.cuda.get_device_name(0),
        boundary_ns=bound, spans_per_iteration=per_it, ranges_before=before,
        ranges_added=added,
        # what the change adds to a step with collection off: the branch on
        # the ranges the step had, and the added ranges whole
        off_us_per_step=(before * (bound["off"] - bound["ranges alone"])
                         + added * bound["off"]) / 1e3,
        on_us_per_step=(before + added) * (bound["on"] - bound["off"]) / 1e3,
        medians=med,
        profiler_share={m: 1 - med["on"]["host"][m] / med["traced"]["host"][m]
                        for m in HOST if med["traced"]["host"][m]})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
