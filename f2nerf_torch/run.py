"""The port's CLI, beside the JAX package's ``scripts/run.py`` and with the
same hydra-style workflow (reference scripts/run.py:37-78):

    python -m f2nerf_torch.run --config-name=wanjinyou \\
        dataset_name=example case_name=ngp_fox mode=train [+work_dir=...]

Same configs (``confs/``), same overrides, same side effects:
image_list.txt generation, the source backup into
exp/<case>/<exp>/record/, runtime_config.yaml dumps, and the output tree
exp/<case>/<exp>/{images,test_images,novel_images,checkpoints,...}.

The device is explicit: ``+device=cuda`` (the default) needs a CUDA card
and raises without one; ``+device=cpu`` runs the kernels' plain versions.

Data parallel: ``torchrun --nproc_per_node=N -m f2nerf_torch.run ...``
starts N ranks, one shard each (``parallel/data_parallel.py``). Each joins
the process group from torchrun's environment (NCCL on the cards, gloo
with ``+device=cpu``) and trains on ``cuda:LOCAL_RANK``; rank 0 alone
writes, and the group is left at exit.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil

import torch.distributed

from .parallel import data_parallel as dp
from .utils import config as cfglib

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKUP_PATTERNS = [
    "./confs/**/*.yaml",
    "./f2nerf_torch/**/*.py",
    "./f2nerf_torch/csrc/*.cu",
]


def require_device(device: str) -> None:
    """Raise unless ``device`` can run here: a CUDA device needs a card
    (nothing falls back to the CPU)."""
    if device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but "
                               "torch.cuda.is_available() is False; pass "
                               "+device=cpu (run) or --device cpu (bench) "
                               "to run on the CPU")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config-name", dest="config_name", default="wanjinyou")
    parser.add_argument("--config-path", dest="config_path", default=None)
    parser.add_argument("overrides", nargs="*",
                        help="hydra-style key=value overrides")
    args = parser.parse_args(argv)

    config_dir = args.config_path or os.path.join(REPO_ROOT, "confs")
    cfg = cfglib.compose(config_dir, args.config_name, args.overrides)
    cfg["device"] = str(cfg.get("device") or "cuda")
    require_device(cfg["device"])
    # under torchrun: join its group here, leave it at exit
    joined = "WORLD_SIZE" in os.environ and not dp.initialized()
    if joined:
        dp.init_distributed(backend="gloo" if cfg["device"] == "cpu" else None)
    try:
        return _run(cfg)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _run(cfg: dict):
    if cfg["device"] == "cuda" and dp.initialized():
        cfg["device"] = f"cuda:{os.environ.get('LOCAL_RANK', 0)}"
    lead = dp.world()[0] == 0

    base_dir = cfg.get("work_dir") or os.getcwd()
    data_path = os.path.join(base_dir, "data", cfg["dataset_name"], cfg["case_name"])
    base_exp_dir = os.path.join(base_dir, "exp", cfg["case_name"], cfg["exp_name"])
    record_dir = os.path.join(base_exp_dir, "record")
    cfg["dataset"]["data_path"] = data_path
    cfg["base_dir"] = base_dir
    cfg["base_exp_dir"] = base_exp_dir
    if lead:
        print(f"Working directory is {base_dir}")
        _write_run_files(cfg, record_dir)
    dp.barrier()     # the image list exists before any rank loads images

    from .train.runner import Runner
    runner = Runner(cfg)
    runner.execute()
    return runner


def _write_run_files(cfg: dict, record_dir: str) -> None:
    """The source backup (reference scripts/run.py:52-61), image_list.txt
    and the runtime_config.yaml dumps."""
    os.makedirs(record_dir, exist_ok=True)
    for pattern in BACKUP_PATTERNS:
        for path in glob.glob(os.path.join(REPO_ROOT, pattern), recursive=True):
            rel = os.path.relpath(path, REPO_ROOT)
            dst = os.path.join(record_dir, rel)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copyfile(path, dst)

    from .data.dataset import make_image_list
    make_image_list(cfg["dataset"]["data_path"], float(cfg["dataset"]["factor"]))
    cfglib.save(cfg, os.path.join(record_dir, "runtime_config.yaml"))
    cfglib.save(cfg, os.path.join(os.getcwd(), "runtime_config.yaml"))


if __name__ == "__main__":
    main()
