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
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil

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

    base_dir = cfg.get("work_dir") or os.getcwd()
    print(f"Working directory is {base_dir}")

    data_path = os.path.join(base_dir, "data", cfg["dataset_name"], cfg["case_name"])
    base_exp_dir = os.path.join(base_dir, "exp", cfg["case_name"], cfg["exp_name"])
    os.makedirs(base_exp_dir, exist_ok=True)

    # source backup (reference scripts/run.py:52-61)
    record_dir = os.path.join(base_exp_dir, "record")
    os.makedirs(record_dir, exist_ok=True)
    for pattern in BACKUP_PATTERNS:
        for path in glob.glob(os.path.join(REPO_ROOT, pattern), recursive=True):
            rel = os.path.relpath(path, REPO_ROOT)
            dst = os.path.join(record_dir, rel)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copyfile(path, dst)

    from .data.dataset import make_image_list
    make_image_list(data_path, float(cfg["dataset"]["factor"]))

    cfg["dataset"]["data_path"] = data_path
    cfg["base_dir"] = base_dir
    cfg["base_exp_dir"] = base_exp_dir
    cfglib.save(cfg, os.path.join(record_dir, "runtime_config.yaml"))
    cfglib.save(cfg, os.path.join(os.getcwd(), "runtime_config.yaml"))

    from .train.runner import Runner
    runner = Runner(cfg)
    runner.execute()
    return runner


if __name__ == "__main__":
    main()
