"""The readings that the check's limits are set from, for one cell.

    python3 -m cellbench.control --workload <cell> --seeds 1,2,3 --seconds 2

For each seed, in one process: the cell's set-up and a short window, then
the numbers the check compares twice: the program against the reference
(the lower reading), and the control against the reference (the upper
reading): the reference itself computed with its field in bfloat16
(``reference.step.lower_precision``), where the configuration states
float32. Prints one JSON line a seed, and the largest program reading and
the smallest control reading of each number at the end. The benchmark's
own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

from . import manifest


def readings(cell: str, seed: int, seconds: float, device: str = "cuda:0",
             cfg_doc: dict | None = None, mix: dict | None = None) -> dict:
    """One seed's readings: {"program": {...}, "control": {...}, "settle":
    {...}}. ``cfg_doc`` and ``mix`` replace the cell's files (the CPU tests
    pass small ones)."""
    import torch
    from .cell import Run

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cfg_doc is None or mix is None:
        w = manifest.workload(manifest.benchmark(os.getcwd()), cell)
        cfg_doc, mix = manifest.config(w["config"]), manifest.mix(w["traffic"])
    tmp = tempfile.mkdtemp(prefix="cellbench_control_")
    try:
        run = Run(cfg_doc, mix, seed, device, tmp)
        run.setup()
        if mix["mode"] == "train":
            run.train_window(seconds)
            run.free_program()
            prog, seen = run.check_train(), run.info["check"]
            ctrl = run.check_train(lower=True)
        else:
            run.render_window(seconds)
            run.keep_for_render_check()
            run.free_program()
            prog, seen = run.check_render(), run.info["check"]
            ctrl = run.check_render(lower=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(seed=seed, program=prog, control=ctrl, program_seen=seen,
                control_seen=run.info["check"], settle=run.info["settle"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("cellbench.control: no CUDA card", file=sys.stderr)
        return 2
    rows = []
    for s in args.seeds.split(","):
        rows.append(readings(args.workload, int(s), args.seconds))
        print(json.dumps(rows[-1]), flush=True)
    names = list(rows[0]["program"])
    summary = {k: dict(lower=max(r["program"][k] for r in rows),
                       upper=min(r["control"][k] for r in rows)) for k in names}
    print(json.dumps(dict(workload=args.workload, seeds=len(rows), readings=summary)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
