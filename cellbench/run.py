"""Run one benchmark cell of the port (``f2nerf_torch``) once.

    python3 -m cellbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. Set-up (scene,
Trainer, the seed's weights, subdivision, settle, warm-up), then the
measured window of ``--seconds``, then the check against the plain
reference under ``cellbench/reference/``. The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics, read from a ``torch.profiler`` record of the window), ``device``,
with ``--trace 1`` ``breakdown``, and last ``compared``: each number the
check compared, with its limit. Earlier lines carry the set-up's parts,
the settled controller, the window's counts and the device time no span
claims. A run exits non-zero and prints no result without a CUDA card (it
never falls back to the CPU), or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from . import manifest  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "f2nerf_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    jaxlib's, flax's or the JAX package's, compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def log(msg: str) -> None:
    print(f"[cellbench] {msg}", flush=True)


def counts_for(run, mode: str, device_name: str) -> dict:
    """The yardstick's counts for the cell's per-layer readers."""
    from . import counts
    from .reference.step import N_EDGE
    cfg, out = run.cfg, dict(counts.peak(device_name) or {})
    out["sample_flops"] = counts.sample_flops(cfg)
    if mode == "train":
        k = run.step_key
        n_scatter = k["cap2"] + 2 * N_EDGE
        kept = [min(s["n_meaningful"], k["cap2"]) for s in run.info["check_steps"]]
        out["scatter_bytes"] = counts.scatter_bytes(cfg, n_scatter)
        out["grad_samples"] = sum(kept) / len(kept) + 2 * N_EDGE
    else:
        out["samples_per_ray"] = run.info.get("render_samples_per_ray")
    return out


def run_cell(cell: str, cfg_doc: dict, mix: dict, bench: dict, seed: int, seconds: float,
             trace: bool, device: str, tmp: str, t_start: float) -> dict:
    """Set up, measure and check one run; return the result line's object
    (without ``device``'s card fields when ``device`` is the CPU)."""
    import torch
    from .cell import Run

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mode = mix["mode"]
    run = Run(cfg_doc, mix, seed, device, tmp)
    run.setup()
    log("setup parts (s): " + json.dumps(run.parts))
    log("settled: " + json.dumps(run.info["settle"]))
    if "check_steps" in run.info:
        log("check steps: " + json.dumps(run.info["check_steps"]))
    window = run.train_window if mode == "train" else run.render_window
    on_card = torch.device(device).type == "cuda"
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res = window(min(seconds, float(mix["trace_seconds"])))
    else:
        res = window(seconds)
    setup_s = res["t0"] - t_start
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    log("window: " + json.dumps({k: v for k, v in res.items() if k != "t0"}))
    if mode == "render":
        run.keep_for_render_check()
    run.free_program()
    compared = run.check_train() if mode == "train" else run.check_render()
    log("check: " + json.dumps(run.info["check"]))
    limits = cfg_doc.get("limits", {}).get(mode, {})
    checks = {k: dict(value=v, limit=limits.get(k)) for k, v in compared.items()}
    correct = all(c["limit"] is not None and math.isfinite(c["value"])
                  and c["value"] <= c["limit"] for c in checks.values())

    unit = "iterations" if mode == "train" else "images"
    out = dict(correct=bool(correct), attempted=int(res[unit]), failed=int(res["failed"]))
    dev = dict(platform="gpu" if on_card else "cpu",
               kind=torch.cuda.get_device_name(device) if on_card else "cpu",
               count=1, memory_peak_bytes=int(peak))
    metrics = {}
    if trace:
        from .trace import TraceView
        counters = dict(rays=res["rays"], chunks=res.get("chunks", 0), redo=res.get("redo", 0))
        units = {unit: res[unit]}
        view = TraceView(prof, res["seconds"], mode, units, counters,
                         counts_for(run, mode, dev["kind"]))
        del prof
        log(f"trace: busy {view.busy_s:.6f} s of {res['seconds']:.6f} s; device activities "
            f"{view.kernel_ms_total:.3f} ms, of which no span claims {view.unclaimed_ms:.3f} ms "
            f"and {view.unlinked_ms:.3f} ms have no launch in the record; spans (device ms) "
            + json.dumps(view.span_ms))
        idlest = sorted(view.idle_by_span, key=lambda k: -view.idle_by_span[k])[:3]
        log("host time of the idlest spans (ms, outermost aten ops, the costliest ops "
            "[op, ms, count]) over the window: "
            + json.dumps({k: view.host_by_span.get(k) for k in idlest}))
        for m in manifest.metrics_for(bench, "per_layer", cell):
            v = manifest.reader(m["name"])(view)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
        dev.update(busy_s=view.busy_s, window_s=res["seconds"])
        out["metrics"] = metrics
        out["device"] = dev
        out["breakdown"] = view.breakdown()
    else:
        rate = res["rays"] / res["seconds"]
        values = {f"{mode}_rays_per_s": rate, "setup_s": setup_s}
        for m in manifest.metrics_for(bench, "end_to_end", cell):
            if m["name"] in values:
                metrics[m["name"]] = dict(value=float(values[m["name"]]), unit=m["unit"])
        out["metrics"] = metrics
        out["device"] = dev
    out["compared"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = os.getcwd()
    cache = os.path.join(root, ".cellbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    bench = manifest.benchmark(root)
    w = manifest.workload(bench, args.workload)
    cfg_doc, mix = manifest.config(w["config"]), manifest.mix(w["traffic"])

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(w["chips"]):
        print(f"cellbench: {args.workload} needs {w['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() is {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    tmp = tempfile.mkdtemp(prefix="cellbench_")
    try:
        out = run_cell(args.workload, cfg_doc, mix, bench, args.seed, args.seconds,
                       bool(args.trace), "cuda:0", tmp, T_START)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        print(f"cellbench: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    for k, c in out["compared"].items():
        print(f"compared {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
