"""Training-throughput benchmark of the port. Prints one JSON line:
  {"metric": ..., "value": N, "unit": "rays/sec", "vs_baseline": N}

    python -m f2nerf_torch.bench                # on the CUDA card (raises without one)
    python -m f2nerf_torch.bench --device cpu   # the kernels' plain versions

The same measurement as the JAX package's bench.py, without JAX.
Workload: ngp_fox under the wanjinyou config when
data/example/ngp_fox is in the repo, else the synthetic ball scene with
TINY_OVERRIDES. Steps: settle, freeze the controller, one ``train_auto``,
then 40 timed steps through ``train_auto(sync=False)`` ending with one
``train_auto(sync=True)``; rays/s is the iterations run times the frozen
bucket's ray count over the host seconds.

BASELINE_RAYS_PER_SEC is the reference paper's claim, not a measurement:
~12 min for 20k iterations on one RTX 2080Ti (~27.8 it/s) at its
steady-state batch of ~13k rays (262144 target points / ~20 meaningful
samples a ray, ExpRunner.cpp:86).

Environment, as bench.py reads it: F2_BENCH_SYNTH=1 takes the ball scene
even when ngp_fox is present; F2_BENCH_SETTLE=<n> sets the settle
iterations (250 from scratch, 24 past a resumed checkpoint);
F2_BENCH_CKPT=0 (or none) trains from scratch, F2_BENCH_CKPT=<dir> resumes
from that checkpoint (by default the newest full fox run under exp/, as
bench.py looks for it).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

from .run import REPO_ROOT, require_device
from .utils.config import compose
from .utils.synthetic import TINY_OVERRIDES, write_ball_dataset

BASELINE_RAYS_PER_SEC = 3.6e5
TIMED_STEPS = 40
CKPT_RUNS = ("r5full", "r4fix", "r4full", "r3full", "r2long")


def find_dataset(tmp: str) -> tuple[str, list | None]:
    """(data path, None) for ngp_fox in the repo, else the ball scene
    written under ``tmp`` and TINY_OVERRIDES."""
    if os.environ.get("F2_BENCH_SYNTH", "0") != "1":
        fox = os.path.join(REPO_ROOT, "data", "example", "ngp_fox")
        if os.path.exists(os.path.join(fox, "cams_meta.npy")):
            return fox, None
    return write_ball_dataset(os.path.join(tmp, "ball")), list(TINY_OVERRIDES)


def _sync(tr) -> None:
    if tr.device.type == "cuda":
        torch.cuda.synchronize(tr.device)


def prepare(tmp: str, overrides: list | None = None, settle: int | None = None,
            device: str = "cuda"):
    """A Trainer settled past the init transient with its controller
    frozen, after one more ``train_auto``: the state the timed window
    starts from. ``overrides`` replaces the data fallback's (the ball's
    TINY_OVERRIDES); ``settle`` replaces F2_BENCH_SETTLE. Returns
    (trainer, workload name, the frozen bucket's n_rays)."""
    from .train.trainer import Trainer

    require_device(device)
    data_path, extra = find_dataset(tmp)
    workload = "ngp_fox" if extra is None else "synthetic-ball"
    cfg = compose(os.path.join(REPO_ROOT, "confs"), "wanjinyou",
                  extra if overrides is None else list(overrides))
    tr = Trainer(cfg, os.path.join(tmp, "exp"), data_path, seed=2022,
                 device=device)

    # steady state: resume a real run's checkpoint where one exists (fox
    # only), so the window sees the post-milestone operating point
    ckpt_env = os.environ.get("F2_BENCH_CKPT", "")
    ckpt = None
    if ckpt_env not in ("0", "none") and extra is None:
        cands = [ckpt_env] if ckpt_env else []
        cands += [os.path.join(REPO_ROOT, "exp", "ngp_fox", e, "checkpoints", "latest")
                  for e in CKPT_RUNS]
        ckpt = next((c for c in cands if c and os.path.isdir(c)), None)
    if ckpt:
        tr.load_checkpoint(ckpt)
        workload += f"@iter{tr.iter_step}"
        default_settle, base = 24, tr.iter_step
    else:
        default_settle, base = 250, 0
    if settle is None:
        settle = int(os.environ.get("F2_BENCH_SETTLE", str(default_settle)))
    while tr.iter_step < base + settle:
        tr.train_auto(sync=(tr.iter_step % 64 == 56))
    # pin the bucket so the timed window has no recompiles
    tr.freeze_controller()
    m = tr.train_auto()
    return tr, workload, m["n_rays"]


def time_steps(tr, steps: int, pipelined: bool = True) -> tuple[int, float]:
    """At least ``steps`` more iterations, timed on the host clock between
    two device synchronisations. Pipelined: ``train_auto(sync=False)``
    (chunks where aligned, the metric fetch deferred), then one
    ``train_auto(sync=True)``, as bench.py times them; else one synced
    ``train_one`` an iteration. Returns (iterations run, seconds)."""
    _sync(tr)
    it0, t0 = tr.iter_step, time.perf_counter()
    if pipelined:
        while tr.iter_step < it0 + steps:
            tr.train_auto(sync=False)
        tr.train_auto(sync=True)
    else:
        while tr.iter_step < it0 + steps:
            tr.train_one(sync=True)
    _sync(tr)
    return tr.iter_step - it0, time.perf_counter() - t0


def run_bench(overrides: list | None = None, settle: int | None = None,
              timed_steps: int = TIMED_STEPS, device: str = "cuda") -> dict:
    """The benchmark: ``prepare``, then ``timed_steps`` pipelined steps.
    Data and experiment files live in a temporary directory removed at
    the end. Returns bench.py's JSON line as a dict."""
    with tempfile.TemporaryDirectory(prefix="f2bench_") as tmp:
        tr, workload, n_rays = prepare(tmp, overrides, settle, device)
        iters, secs = time_steps(tr, timed_steps, pipelined=True)
    rays_per_sec = iters * n_rays / secs
    return {
        "metric": f"{workload} wanjinyou training throughput",
        "value": round(rays_per_sec, 1),
        "unit": "rays/sec",
        "vs_baseline": round(rays_per_sec / BASELINE_RAYS_PER_SEC, 4),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    args = ap.parse_args(argv)
    out = run_bench(device=args.device)
    name = torch.cuda.get_device_name(0) if args.device.startswith("cuda") \
        else "cpu"
    print(f"device: {name}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
