"""The port's CLI and Runner (``python -m f2nerf_torch.run``) against the
JAX package's (``scripts/run.py``) on the synthetic scene, on the CPU.

Both CLIs run tests/test_cli.py's overrides (the port's with +device=cpu):
train 4 iterations, then the test render. The port then runs mode=test
and mode=render_path from its checkpoint, and mode=test from the JAX
CLI's checkpoint, whose per-image PSNR must agree with the JAX info.yaml
within EVAL_TOL["psnr_db"] (f2nerf_torch/utils/parity.py). The loop's
graceful stop and vis cadence mirror tests/test_graceful_stop.py with a
stand-in trainer.
"""

import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
import yaml

from f2nerf_torch import run as port_cli
from f2nerf_torch.train.runner import Runner
from f2nerf_torch.utils.parity import EVAL_TOL
from f2nerf_torch.utils.synthetic import write_ball_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

OVERRIDES = [
    "dataset_name=synth", "case_name=ball", "dataset.factor=1",
    "+train.data_parallel=off",
    "train.pts_batch_size=4096", "train.end_iter=4",
    "train.report_freq=2", "train.vis_freq=1000", "train.save_freq=3",
    "pts_sampler.bbox_levels=6", "pts_sampler.max_level=3",
    "pts_sampler.sample_l=0.03125", "train.ray_march_init_fineness=2",
    "field.log2_table_size=10",
    "+capacity.max_nodes=8192", "+capacity.max_trans=512",
    "+capacity.max_edges=16384",
    # both CLIs: 512-ray eval chunks keep the CPU renders' flat buffers
    # small (the default 4096-ray chunk sizes them for the card)
    "+eval.chunk=512",
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's own intra-op
    pool would oversubscribe the cores, and these renders are many small
    ops that gain nothing from it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree_of(exp: str) -> set:
    """Relative paths under an experiment dir, the source backup's package
    folder (f2nerf_tpu/ or f2nerf_torch/) left out."""
    out = set()
    for root, dirs, files in os.walk(exp):
        rel = os.path.relpath(root, exp)
        if rel.startswith(os.path.join("record", "f2nerf_")) or \
                rel.startswith(os.path.join("record", "scripts")):
            continue
        for name in files + [d for d in dirs if os.path.islink(os.path.join(root, d))]:
            out.add(os.path.normpath(os.path.join(rel, name)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("work")
    data_dir = base / "data" / "synth" / "ball"
    data_dir.mkdir(parents=True)
    write_ball_dataset(str(data_dir))
    cams = np.load(data_dir / "cams_meta.npy")
    np.save(data_dir / "poses_render.npy",
            np.ascontiguousarray(cams[:3, :12].reshape(-1, 3, 4).astype(np.float64)))
    work = str(base)
    cwd = os.getcwd()
    os.chdir(work)                  # both CLIs write runtime_config.yaml to cwd
    try:
        import run as jax_cli
        jax_cli.main(["--config-name=wanjinyou", f"+work_dir={work}", "mode=train",
                      "exp_name=jax_cli"] + OVERRIDES)
        jax_exp = os.path.join(work, "exp", "ball", "jax_cli")
        jax_tree = tree_of(jax_exp)
        with open(os.path.join(jax_exp, "test_images", "info.yaml")) as f:
            jax_info = yaml.safe_load(f)

        port = ["--config-name=wanjinyou", f"+work_dir={work}", "+device=cpu",
                "exp_name=port_cli"] + OVERRIDES
        port_cli.main(port + ["mode=train"])
        port_exp = os.path.join(work, "exp", "ball", "port_cli")
        port_tree = tree_of(port_exp)
        with open(os.path.join(port_exp, "test_images", "info.yaml")) as f:
            port_info = yaml.safe_load(f)
        port_cli.main(port + ["mode=test", "is_continue=true"])
        port_cli.main(port + ["mode=render_path", "is_continue=true"])
        # the port's test render of the JAX CLI's checkpoint
        port_cli.main(["--config-name=wanjinyou", f"+work_dir={work}", "+device=cpu",
                       "exp_name=jax_cli", "mode=test", "is_continue=true"] + OVERRIDES)
        with open(os.path.join(jax_exp, "test_images", "info.yaml")) as f:
            port_on_jax = yaml.safe_load(f)
    finally:
        os.chdir(cwd)
    return dict(jax_tree=jax_tree, port_tree=port_tree, port_exp=port_exp,
                jax_info=jax_info, port_info=port_info, port_on_jax=port_on_jax)


def test_port_cli_writes_the_jax_artifact_set(runs):
    assert runs["port_tree"] == runs["jax_tree"]
    tree = runs["port_tree"]
    for name in ("train_info.txt", "cam_pos.ply", "octree.obj",
                 "record/runtime_config.yaml", "test_images/info.yaml",
                 "test_images/info.json", "checkpoints/latest",
                 "test_images/color_4_000.png", "test_images/depth_4_008.png",
                 "test_images/oct_depth_4_016.png"):
        assert os.path.normpath(name) in tree, name


def test_port_train_then_test_and_render_path(runs):
    exp = runs["port_exp"]
    ck = os.path.join(exp, "checkpoints", "latest", "state.npz")
    # end_iter=4, save_freq=3: latest must be the final state, not iter 3
    assert int(np.load(ck)["iter_step"]) == 4
    assert os.path.exists(os.path.join(exp, "checkpoints", "00000003", "state.npz"))
    info = runs["port_info"]
    assert set(info) == {"0", "8", "16", "mean_psnr"}
    assert np.isfinite(info["mean_psnr"]) and info["mean_psnr"] > 5.0
    with open(os.path.join(exp, "test_images", "info.json")) as f:
        full = json.load(f)
    assert full["lpips"]["mean"] is None and 0.0 < full["ssim"]["mean"] <= 1.0
    # mode=test from the checkpoint renders the same state again
    with open(os.path.join(exp, "test_images", "info.yaml")) as f:
        again = yaml.safe_load(f)
    assert again == pytest.approx(info, abs=1e-9)
    novel = sorted(os.listdir(os.path.join(exp, "novel_images")))
    assert novel == ["4_000.png", "4_001.png", "4_002.png"]


def test_port_psnr_on_jax_checkpoint_matches_jax(runs):
    j, p = runs["jax_info"], runs["port_on_jax"]
    assert set(p) == set(j)
    for k in j:
        assert abs(p[k] - j[k]) <= EVAL_TOL["psnr_db"], (k, p[k], j[k])


# ------------------------------------------------ the loop, stand-in trainer

class FakeDataset:
    test_set = np.array([], np.int64)


class FakeTrainer:
    """Duck-typed stand-in driving only the loop surface train() touches:
    ``train_auto`` runs a chunk of ``chunk_size`` iterations where one is
    aligned and fits the Runner's limit, else one iteration."""

    def __init__(self, test_set=(), chunk_size=1):
        self.chunk_size = chunk_size
        self.iter_step = 0
        self.mse_records = [1e-2]
        self.psnr_smooth = 20.0
        self.trunc_ema = 0.0
        self.ema_oct = self.ema_sampled = self.ema_meaningful = 1.0
        self.dataset = FakeDataset()
        self.dataset.test_set = np.asarray(test_set, np.int64)
        self.saved_at = []

    def train_auto(self, sync=True, limit=None):
        import time
        time.sleep(0.002)
        k = self.chunk_size
        if self.iter_step % k or (limit is not None and limit < k):
            k = 1
        self.iter_step += k
        return dict(n_rays=512) if sync else None

    def save_checkpoint(self):
        self.saved_at.append(self.iter_step)


def make_runner(tmp_path, end_iter=10_000_000, trainer=None):
    r = Runner.__new__(Runner)
    r.cfg = {}
    r.base_exp_dir = str(tmp_path)
    r.trainer = trainer or FakeTrainer()
    r.end_iter = end_iter
    r.report_freq = 1 << 30
    r.vis_freq = 1 << 30
    r.stats_freq = 1 << 30
    r.save_freq = 1 << 20
    r.test_images = lambda: setattr(r, "tested", True)
    return r


def test_sigterm_saves_and_finishes(tmp_path):
    r = make_runner(tmp_path)
    timer = threading.Timer(0.2, lambda: os.kill(os.getpid(), signal.SIGTERM))
    timer.start()
    r.train()  # would run ~forever without the graceful stop
    tr = r.trainer
    assert tr.saved_at, "graceful stop must save the final state"
    assert tr.saved_at[-1] == tr.iter_step
    assert getattr(r, "tested", False), "end-of-train test render must run"
    assert os.path.exists(os.path.join(str(tmp_path), "train_info.txt"))
    assert tr.iter_step < r.end_iter
    # handler was restored: a later SIGTERM must not be swallowed
    assert signal.getsignal(signal.SIGTERM) in (
        signal.SIG_DFL, signal.default_int_handler, signal.Handlers.SIG_DFL)


def test_normal_completion_and_cadences(tmp_path, capsys):
    """end_iter off the save cadence still saves at the end; stats, save
    before vis, and a vis failure is logged and training goes on."""
    r = make_runner(tmp_path, end_iter=7, trainer=FakeTrainer(test_set=[0, 8], chunk_size=2))
    r.save_freq, r.stats_freq, r.vis_freq, r.report_freq = 3, 2, 2, 5
    seen = []

    def vis(idx):
        seen.append((r.trainer.iter_step, idx, list(r.trainer.saved_at)))
        if len(seen) == 2:
            raise RuntimeError("out of memory")
    r.visualize_image = vis
    r.train()
    tr = r.trainer
    assert tr.iter_step == 7 and tr.saved_at == [3, 6, 7]
    assert getattr(r, "tested", False)
    assert [(s, i) for s, i, _ in seen] == [(2, 8), (4, 0), (6, 8)]
    assert seen[2][2][-1] == 6          # saved before the vis of step 6
    assert os.path.exists(os.path.join(str(tmp_path), "stats.npy"))
    out = capsys.readouterr().out
    assert "[vis] render failed at iter 4" in out
    assert "Iter:      5 PSNR: 20.00 NRays:   512" in out


def test_runner_and_cli_import_without_jax():
    code = ("import f2nerf_torch.run, f2nerf_torch.train.runner, sys; "
            "assert 'jax' not in sys.modules and 'f2nerf_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)


def test_cli_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        port_cli.main(["--config-name=wanjinyou", f"+work_dir={tmp_path}",
                       "mode=train"] + OVERRIDES)
