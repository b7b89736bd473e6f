"""Data-parallel training in the port (one torch.distributed rank a shard,
gloo on the CPU) against the JAX package's mesh (the conftest's 8 virtual
CPU devices, as tests/test_multichip.py runs it).

The port's ranks run as separate processes (``run_ranks``) that import no
jax: each gets a worker script, joins a gloo group through a file in the
test's temporary directory (no TCP port to collide with other test
workers), writes what it computed to an npz, and is killed if it outlives
its wall-clock limit. The parent computes the JAX side and compares.

  (a) each shard's camera rows against JAX's ``shard_data`` layout, and
      the one camera-slice rule against JAX's ``process_camera_slice``;
  (b) one 2-shard step from a JAX checkpoint with the JAX step's folded
      draws and statics: loss, stats, the reduced gradients, params, Adam
      state and occupancy within STEP_TOL, the two ranks bitwise equal;
  (c) a 3-rank ``train_auto`` run (a chunk of 10, then single steps) over
      a padded camera pool: every rank's state bitwise equal;
  (d) the controller (buckets, caps, per-shard statics) against a JAX
      Trainer with data_parallel=2 at the same EMAs;
  (e) the CLI with 2 ranks, each in its own work dir: only rank 0 writes,
      and its checkpoint resumes in the single-device port and in JAX.

The dataset has 22 cameras, so 19 train cameras: a padded pool for 2, 3
and 8 shards.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f2nerf_tpu.data import dataset as jds
from f2nerf_tpu.parallel import data_parallel as jdp
from f2nerf_tpu.render.renderer import render as jrender
from f2nerf_tpu.train import schedules
from f2nerf_tpu.train import trainer as jtr
from f2nerf_tpu.utils.config import compose
from f2nerf_tpu.utils.synthetic import TINY_OVERRIDES, write_ball_dataset
from f2nerf_torch.data import dataset as tds
from f2nerf_torch.parallel import data_parallel as tdp
from f2nerf_torch.train import trainer as ttr
from f2nerf_torch.utils.parity import STEP_TOL, step_agrees, step_errors
from f2nerf_torch.utils.tree import named_leaves
from test_torch_train_step import OCC, jax_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFS = os.path.join(REPO, "confs")
N_CAMS = 22
OVERRIDES = list(TINY_OVERRIDES) + ["+train.fused_adam=true"]
RANK_TIMEOUT_S = 240

# every worker starts so: its rank, the world size and its output dir from
# the command line, one torch thread (the suite runs in parallel workers),
# then the gloo group
WORKER_HEAD = r'''
import json, os, sys
sys.path.insert(0, os.environ["F2_REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
from f2nerf_torch.parallel import data_parallel as dp
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
spec = json.load(open(os.path.join(out, "spec.json")))
dp.init_distributed(backend="gloo", init_method="file://" + os.path.join(out, "pg"),
                    world_size=world, rank=rank, timeout_s=120)
assert dp.world() == (rank, world)
'''
WORKER_TAIL = r'''
dp.barrier()
torch.distributed.destroy_process_group()
assert "jax" not in sys.modules and "f2nerf_tpu" not in sys.modules
'''


def run_ranks(body: str, world: int, out, spec: dict) -> list[dict]:
    """Run ``body`` (after WORKER_HEAD) in ``world`` processes; each saves
    ``rank<r>.npz`` in ``out``. Returns those files' contents. Any rank
    that fails or outlives RANK_TIMEOUT_S fails the test; every process
    is killed in the end."""
    out = str(out)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "spec.json"), "w") as f:
        json.dump(spec, f)
    script = os.path.join(out, "worker.py")
    with open(script, "w") as f:
        f.write(WORKER_HEAD + body + WORKER_TAIL)
    env = dict(os.environ, F2_REPO=REPO, OMP_NUM_THREADS="1")
    procs, logs = [], []
    try:
        for r in range(world):
            logs.append(open(os.path.join(out, f"rank{r}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, script, str(r), str(world), out], cwd=REPO, env=env,
                stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + RANK_TIMEOUT_S
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        text = []
        for r, f in enumerate(logs):
            f.seek(0)
            text.append(f"--- rank {r} (exit {procs[r].returncode}):\n{f.read()[-3000:]}")
            f.close()
    assert all(p.returncode == 0 for p in procs), "\n".join(text)
    res = []
    for r in range(world):
        with np.load(os.path.join(out, f"rank{r}.npz"), allow_pickle=False) as z:
            res.append({k: z[k] for k in z.files})
    return res


def assert_bitwise_equal(a: dict, b: dict, keys):
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return write_ball_dataset(str(tmp_path_factory.mktemp("ball22")), n_cams=N_CAMS)


# ------------------------------------------------------------------ (a)

@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_shard_layout_matches_jax(data_dir, n_shards, monkeypatch):
    cfg = compose(CONFS, "wanjinyou", OVERRIDES)
    jd = jds.Dataset(data_dir, cfg["dataset"])
    mesh = jdp.make_mesh(n_shards)
    sharded = jdp.shard_data(jd.device_arrays(n_shards=n_shards), mesh)
    td = tds.Dataset(data_dir, cfg["dataset"])
    n_train = len(td.train_set)
    assert n_train == 19 and n_train % n_shards
    for r in range(n_shards):
        mine = td.device_arrays("cpu", n_shards, r)
        for k in ("train_ids", "train_images"):
            shard = next(s for s in sharded[k].addressable_shards
                         if s.device == mesh.devices[r])
            np.testing.assert_array_equal(mine[k].numpy(), np.asarray(shard.data),
                                          err_msg=f"{k} shard {r}")
        for k in ("poses", "intri", "dist", "bounds"):
            np.testing.assert_array_equal(mine[k].numpy(), np.asarray(sharded[k]))

    # the one camera-slice rule: this rank's rows of the padded pool. JAX's
    # process_camera_slice divides the unpadded count; it agrees where the
    # count divides evenly and drops the padding (and, for 8 processes,
    # leaves the last one no camera) where it does not
    def jax_slice(n, r):
        monkeypatch.setattr(jax, "process_count", lambda: n_shards)
        monkeypatch.setattr(jax, "process_index", lambda: r)
        return np.arange(n)[jdp.process_camera_slice(n)]

    monkeypatch.setattr(tdp, "world", lambda: (n_shards - 1, n_shards))
    last = tdp.process_camera_slice(n_train)
    np.testing.assert_array_equal(last, tdp.shard_rows(n_train, n_shards, n_shards - 1))
    np.testing.assert_array_equal(td.train_set[last],
                                  td.device_arrays("cpu", n_shards, n_shards - 1)
                                  ["train_ids"].numpy())
    assert len(jax_slice(n_train, n_shards - 1)) < len(last)
    for r in range(n_shards):
        np.testing.assert_array_equal(jax_slice(4 * n_shards, r),
                                      tdp.shard_rows(4 * n_shards, n_shards, r))


# --------------------------------------------------------------- (b), (d)

STEP_WORKER = r'''
from f2nerf_torch.render.renderer import RenderStatics
from f2nerf_torch.train import trainer as ttr
from f2nerf_torch.utils import convert
from f2nerf_torch.utils.config import compose
from f2nerf_torch.utils.tree import named_leaves

cfg = compose(os.path.join(os.environ["F2_REPO"], "confs"), "wanjinyou", spec["overrides"])
with np.load(os.path.join(spec["ckpt"], "state.npz")) as z:
    host = convert.octree_from_named(z)
pt = ttr.Trainer(cfg, os.path.join(out, f"exp{rank}"), spec["data_dir"], device="cpu",
                 tree_host=host)
pt.load_checkpoint(spec["ckpt"])
assert pt.n_shards == world and pt.rank == rank and pt.reduce is not None
with np.load(os.path.join(out, f"draws{rank}.npz")) as z:
    draws = {k: torch.from_numpy(z[k]) for k in z.files}
core = ttr.make_core(cfg, RenderStatics(**spec["statics"]), pt.dataset.height,
                     pt.dataset.width, dist=pt.reduce)
rt = {k: torch.tensor(v, dtype=torch.float32) for k, v in spec["runtime"].items()}
tree, aux, grads = core(pt.params, pt.opt_state, pt.tree, pt.consts, pt.data, rt,
                        draws, spec["n_local"])
res = dict(loss=aux["loss"].numpy(), finite=aux["grads_finite"].numpy(),
           count=pt.opt_state["count"].numpy(), train_ids=pt.data["train_ids"].numpy())
res.update({"stat:" + k: v.numpy() for k, v in aux["stats"].items()})
res.update({"aux:" + k: aux[k].numpy() for k in ("color_loss", "tv_loss", "var_loss", "mse")})
res.update({"g:" + k: v.numpy() for k, v in named_leaves(grads)})
res.update({"p:" + k: v.detach().numpy() for k, v in named_leaves(pt.params)})
res.update({"mu:" + k: v.numpy() for k, v in named_leaves(pt.opt_state["mu"])})
res.update({"nu:" + k: v.numpy() for k, v in named_leaves(pt.opt_state["nu"])})
res.update({"occ:" + k: getattr(tree, k).numpy() for k in spec["occ"]})

# (d): the controller at given EMAs, as the JAX Trainer is read
ctl = []
for ema_s, ema_m, ema_o in spec["emas"]:
    pt.ema_sampled, pt.ema_meaningful, pt.ema_oct = ema_s, ema_m, ema_o
    pt._cur_bucket, pt._cap_memo, pt.hit_cap = None, {}, 64
    n_rays = pt.cur_batch_size()
    st = pt._get_step(n_rays)[1]
    ctl.append([n_rays, st.max_s, st.cap1, st.cap2, st.max_hits,
                *pt._caps(n_rays // world, st.max_s)])
res["controller"] = np.asarray(ctl, np.int64)
np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
'''
EMAS = [(512.0, 512.0, 16.0), (180.0, 40.0, 30.0), (60.0, 8.0, 55.0),
        (300.0, 2.0, 100.0), (90.0, 1.0, 10.0)]


@pytest.fixture(scope="module")
def two_shard_step(data_dir, tmp_path_factory):
    """A JAX Trainer on a 2-device mesh takes two steps and saves; then one
    more sharded JAX step from that state, and the port's two ranks take
    the same step from the saved state.npz with the JAX step's folded
    draws (``fold_in(key, shard)``) and its per-shard statics."""
    cfg = compose(CONFS, "wanjinyou", OVERRIDES + ["+train.data_parallel=2"])
    jt = jtr.Trainer(cfg, str(tmp_path_factory.mktemp("jax_dp")), data_dir, seed=2022)
    assert jt.n_shards == 2
    for _ in range(2):
        jt.train_one()
    jt.save_checkpoint()
    ckpt = os.path.join(jt.base_exp_dir, "checkpoints", "latest")

    n_rays = jt.cur_batch_size()
    step_fn, st = jt._get_step(n_rays)
    n_local = n_rays // 2
    tcfg = cfg["train"]
    s = jt.iter_step
    runtime = dict(lr=schedules.learning_rate(s, tcfg),
                   fineness=schedules.ray_march_fineness(s, tcfg),
                   grad_progress=schedules.gradient_scaling_progress(s, tcfg),
                   var_loss_weight=schedules.var_loss_weight(s, tcfg))
    rt_j = {k: jnp.asarray(v, jnp.float32) for k, v in runtime.items()}
    key = jax.random.PRNGKey(123)
    out = tmp_path_factory.mktemp("ranks_b")
    ids = np.asarray(jt.data["train_ids"])
    imgs = np.asarray(jt.data["train_images"])
    per = len(ids) // 2
    loss_w = dict(disp_loss_weight=float(tcfg["disp_loss_weight"]),
                  tv_loss_weight=float(tcfg["tv_loss_weight"]))

    @jax.jit
    def shard_grad(params, data, key):
        # the sharded step's loss on one shard (trainer.py:330-354)
        k_rays, k_render = jax.random.split(jax.random.fold_in(key, data["shard"]))
        rays_o, rays_d, _, gt, img_idx = jds.sample_rays(
            data, k_rays, n_local, jt.dataset.height, jt.dataset.width)

        def loss_fn(p):
            result, _ = jrender(p, jt.consts, jt.tree, rays_o, rays_d, img_idx,
                                k_render, rt_j["fineness"], rt_j["grad_progress"], st)
            return jtr.compute_losses(result, gt, n_local, loss_w, rt_j)[0]
        return jax.grad(loss_fn)(params)

    grads = []
    for r in range(2):
        rows = slice(r * per, (r + 1) * per)
        data_r = {k: jnp.asarray(np.asarray(v)) for k, v in jt.data.items()
                  if k not in ("train_ids", "train_images")}
        data_r.update(train_ids=jnp.asarray(ids[rows]), train_images=jnp.asarray(imgs[rows]),
                      shard=jnp.asarray(r, jnp.uint32))
        grads.append(shard_grad(jt.params, data_r, key))
        d = jax_draws(jax.random.fold_in(key, r), n_local, st, per, jt.dataset.height,
                      jt.dataset.width, jt.tree_host.edge_t.shape[0])
        np.savez(os.path.join(out, f"draws{r}.npz"), **{k: v.numpy() for k, v in d.items()})
    g_mean = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, *grads)
    # the controller at given EMAs (d), read before the step donates jt's state
    ctl = []
    for ema_s, ema_m, ema_o in EMAS:
        jt.ema_sampled, jt.ema_meaningful, jt.ema_oct = ema_s, ema_m, ema_o
        jt._cur_bucket, jt._cap_memo, jt.hit_cap = None, {}, 64
        nr = jt.cur_batch_size()
        sj = jt._get_step(nr)[1]
        ctl.append([nr, sj.max_s, sj.cap1, sj.cap2, sj.max_hits,
                    *jt._caps(nr // 2, sj.max_s)])
    p_j, o_j, tree_j, aux_j = step_fn(jt.params, jt.opt_state, jt.tree, jt.consts,
                                      jt.data, key, rt_j, n_rays)
    jax_side = dict(
        loss=float(aux_j["loss"]), finite=bool(aux_j["grads_finite"]),
        stats={k: float(v) for k, v in aux_j["stats"].items()},
        aux={k: float(aux_j[k]) for k in ("color_loss", "tv_loss", "var_loss", "mse")},
        grads=dict(named_leaves(jax.tree_util.tree_map(np.asarray, g_mean))),
        params=dict(named_leaves(jax.tree_util.tree_map(np.asarray, p_j))),
        mu=dict(named_leaves(jax.tree_util.tree_map(np.asarray, o_j[1].mu))),
        nu=dict(named_leaves(jax.tree_util.tree_map(np.asarray, o_j[1].nu))),
        count=int(o_j[1].count), occ={k: np.asarray(getattr(tree_j, k)) for k in OCC},
        train_ids=[ids[r * per:(r + 1) * per] for r in range(2)],
        controller=np.asarray(ctl, np.int64))
    spec = dict(overrides=OVERRIDES, ckpt=ckpt, data_dir=data_dir, n_local=n_local,
                statics=st._asdict(), runtime=runtime, occ=list(OCC), emas=EMAS)
    ranks = run_ranks(STEP_WORKER, 2, out, spec)
    return dict(jax=jax_side, ranks=ranks, lr=runtime["lr"])


def _side(res: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


def test_two_shard_step_matches_jax(two_shard_step):
    j, (r0, r1) = two_shard_step["jax"], two_shard_step["ranks"]
    assert_bitwise_equal(r0, r1, [k for k in r0 if k != "train_ids"])
    for r, res in enumerate((r0, r1)):
        np.testing.assert_array_equal(res["train_ids"], j["train_ids"][r])
    assert bool(r0["finite"]) and j["finite"]
    assert float(r0["loss"]) == pytest.approx(j["loss"], rel=STEP_TOL["loss_rtol"])
    for k, v in _side(r0, "aux:").items():
        assert float(v) == pytest.approx(j["aux"][k], rel=STEP_TOL["loss_rtol"], abs=1e-12), k
    for k, v in _side(r0, "stat:").items():
        assert float(v) == j["stats"][k], k
    err = step_errors(float(r0["loss"]), j["loss"], _side(r0, "g:"), j["grads"],
                      _side(r0, "p:"), j["params"], _side(r0, "occ:"), j["occ"],
                      two_shard_step["lr"])
    assert step_agrees(err), err
    for k, v in _side(r0, "occ:").items():
        np.testing.assert_array_equal(v, j["occ"][k], err_msg=k)
    assert int(r0["count"]) == j["count"] == 3
    for name in ("mu", "nu"):
        for k, b in j[name].items():
            a = _side(r0, name + ":")[k].astype(np.float64)
            b = b.astype(np.float64)
            assert np.linalg.norm(a - b) <= STEP_TOL["grad_rel"] * np.linalg.norm(b), (name, k)


def test_controller_matches_jax(two_shard_step):
    """Bucket (a multiple of the shard count), per-shard max_s, caps and
    hit cap at the same EMAs, on both ranks."""
    want = two_shard_step["jax"]["controller"]
    assert (want[:, 0] % 2 == 0).all()
    for res in two_shard_step["ranks"]:
        np.testing.assert_array_equal(res["controller"], want)


# ------------------------------------------------------------------ (c)

RUN_WORKER = r'''
from f2nerf_torch.train import trainer as ttr
from f2nerf_torch.utils.config import compose
from f2nerf_torch.utils.tree import named_leaves

cfg = compose(os.path.join(os.environ["F2_REPO"], "confs"), "wanjinyou", spec["overrides"])
tr = ttr.Trainer(cfg, os.path.join(out, f"exp{rank}"), spec["data_dir"], device="cpu")
assert tr.n_shards == world
chunks = []
while tr.iter_step < tr.end_iter:
    s = tr.iter_step
    m = tr.train_auto(sync=True)
    chunks.append([s, tr.iter_step - s, m["n_rays"], m["cap1"], m["cap2"], m["hit_cap"]])
res = dict(chunks=np.asarray(chunks, np.int64), mse=np.asarray(tr.mse_records),
           train_ids=tr.data["train_ids"].numpy(),
           controller=np.asarray([tr.ema_sampled, tr.ema_meaningful, tr.ema_oct,
                                  tr.trunc_ema, tr.sat_ema, tr.b_trunc_ema, tr.oct_max,
                                  tr.psnr_smooth, tr.hit_cap, tr._cur_bucket, tr.iter_step]),
           caps=np.asarray(sorted((k,) + tuple(v) for k, v in tr._cap_memo.items())))
res.update({"p:" + k: v.detach().numpy() for k, v in named_leaves(tr.params)})
res.update({"o:" + k: v.numpy() for k, v in named_leaves(tr.opt_state)})
res.update({"t:" + f: getattr(tr.tree, f).numpy() for f in tr.tree.__dataclass_fields__
            if torch.is_tensor(getattr(tr.tree, f))})
np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
'''


def test_three_rank_train_auto_stays_replicated(data_dir, tmp_path):
    spec = dict(overrides=OVERRIDES + ["train.end_iter=12"], data_dir=data_dir)
    ranks = run_ranks(RUN_WORKER, 3, tmp_path, spec)
    r0 = ranks[0]
    chunks = r0["chunks"]
    assert [tuple(c[:2]) for c in chunks] == [(0, 10), (10, 1), (11, 1)]
    assert (chunks[:, 2] % 3 == 0).all()
    assert np.isfinite(r0["mse"]).all() and len(r0["mse"]) == 12
    seen = set()
    for r, res in enumerate(ranks):
        assert_bitwise_equal(res, r0, [k for k in r0 if k != "train_ids"])
        assert len(res["train_ids"]) == 7             # 19 cameras padded to 21
        seen.update(res["train_ids"].tolist())
    assert len(seen) == 19
    assert not np.array_equal(ranks[0]["train_ids"], ranks[1]["train_ids"])


# ------------------------------------------------------------------ (e)

RUNNER_WORKER = r'''
import shutil
from f2nerf_torch import run

work = os.path.join(out, f"work{rank}")
args = ["--config-name=wanjinyou", f"+work_dir={work}", "+device=cpu"] + spec["overrides"]
run.main(args + ["mode=train"])
dp.barrier()
exp = os.path.join("exp", "ball", "test", "checkpoints")
if rank:
    # a host without the shared disk gets rank 0's checkpoint copied over
    shutil.copytree(os.path.join(out, "work0", exp), os.path.join(work, exp), symlinks=True)
dp.barrier()
runner = run.main(args + ["mode=test", "is_continue=true"])
np.savez(os.path.join(out, f"rank{rank}.npz"), iter_step=runner.trainer.iter_step)
'''
RUNNER_OVERRIDES = [
    "dataset_name=synth", "case_name=ball", "dataset.factor=1",
    "train.pts_batch_size=4096", "train.end_iter=4", "train.report_freq=2",
    "train.vis_freq=2", "train.stats_freq=2", "train.save_freq=3",
    "pts_sampler.bbox_levels=6", "pts_sampler.max_level=3",
    "pts_sampler.sample_l=0.03125", "train.ray_march_init_fineness=2",
    "field.log2_table_size=10", "+capacity.max_nodes=8192",
    "+capacity.max_trans=512", "+capacity.max_edges=16384", "+eval.chunk=600",
]


def files_under(d: str) -> set:
    out = set()
    for root, dirs, files in os.walk(d):
        for name in files + [x for x in dirs if os.path.islink(os.path.join(root, x))]:
            out.add(os.path.relpath(os.path.join(root, name), d))
    return out


def test_two_rank_cli_writes_on_rank_zero_and_resumes(tmp_path):
    # 20x30 images, one eval chunk each: the CPU renders (two vis images,
    # the test split twice) take a third of the 40x60 scene's time
    data_dir = write_ball_dataset(str(tmp_path / "ball"), n_cams=N_CAMS, h=20, w=30)
    for r in range(2):
        shutil.copytree(data_dir, tmp_path / f"work{r}" / "data" / "synth" / "ball")
    os.remove(tmp_path / "work1" / "data" / "synth" / "ball" / "image_list.txt")
    data_files = files_under(str(tmp_path / "work1"))
    ranks = run_ranks(RUNNER_WORKER, 2, tmp_path, dict(overrides=RUNNER_OVERRIDES))
    assert [int(r["iter_step"]) for r in ranks] == [4, 4]

    exp0 = str(tmp_path / "work0" / "exp" / "ball" / "test")
    got = files_under(exp0)
    for f in ("train_info.txt", "stats.npy", "cam_pos.ply", "octree.obj",
              "checkpoints/latest", "checkpoints/00000003/state.npz",
              "checkpoints/00000004/state.npz", "images/2_8.png", "images/4_16.png",
              "test_images/info.yaml", "test_images/info.json",
              "test_images/color_4_000.png", "record/runtime_config.yaml"):
        assert f in got, f
    # rank 1 wrote nothing: its work dir holds its data and the copied
    # checkpoints only
    ckpts = {os.path.join("exp", "ball", "test", f) for f in got if f.startswith("checkpoints")}
    assert files_under(str(tmp_path / "work1")) == data_files | ckpts

    ckpt = os.path.join(exp0, "checkpoints", "latest")
    with np.load(os.path.join(ckpt, "state.npz")) as z:
        saved = {k: z[k] for k in z.files}
    cfg = compose(CONFS, "wanjinyou", RUNNER_OVERRIDES)
    data = str(tmp_path / "work0" / "data" / "synth" / "ball")
    pt = ttr.Trainer(cfg, str(tmp_path / "one"), data, device="cpu")
    assert pt.n_shards == 1
    pt.load_checkpoint(ckpt)
    for k, v in named_leaves(pt.params):
        np.testing.assert_array_equal(v.detach().numpy(), saved["p:" + k], err_msg=k)
    m = pt.train_one()
    assert pt.iter_step == 5 and np.isfinite(m["loss"]) and m["grads_finite"] == 1.0
    jt = jtr.Trainer(compose(CONFS, "wanjinyou", RUNNER_OVERRIDES + ["+train.data_parallel=off"]),
                     str(tmp_path / "jax"), data, seed=2022)
    jt.load_checkpoint(ckpt)
    assert jt.iter_step == 4
    for k, v in named_leaves(jax.tree_util.tree_map(np.asarray, jt.params)):
        np.testing.assert_array_equal(v, saved["p:" + k], err_msg=k)
    assert int(jt.opt_state[1].count) == int(pt.opt_state["count"]) - 1 == 4
