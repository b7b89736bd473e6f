"""The port's host controller, step chunking, deferred metric fetch,
Runner stepping and benchmark entry, against the JAX package's.

  (a) ``_chunk_k`` of both Trainers over a grid of chunk sizes, iterations,
      milestones, compaction periods, end iterations and cadence limits;
  (b) one sequence of host metrics through both ``_ingest_aux``, with the
      controller frozen and not: equal EMAs, hit cap, oct_max, records;
  (c) both Runners driven by one recording stand-in trainer make the same
      ``train_auto`` calls (iteration, chunk, sync) for several cadences;
  (d) ``train_many(k)`` equals k ``train_one`` calls bit for bit at a
      frozen controller (params, Adam state, tree, every metric);
  (e) ``train_many(2)`` with the JAX chunk's draws against JAX's
      ``make_train_chunk(..., 2)`` from one checkpoint, within STEP_TOL;
  (f) pipelined ``train_one(sync=False)`` ingests, once drained, the
      series the synced steps ingest, each step with its own statics;
  (g) ``f2nerf_torch.bench`` on the CPU returns bench.py's keys and
      imports no jax.
All on the CPU at TINY_OVERRIDES.
"""

import contextlib
import copy
import itertools
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f2nerf_tpu.train import runner as jrun
from f2nerf_tpu.train import schedules
from f2nerf_tpu.train import trainer as jtr
from f2nerf_tpu.utils.config import compose
from f2nerf_tpu.utils.synthetic import TINY_OVERRIDES, write_ball_dataset
from f2nerf_torch import bench
from f2nerf_torch.sampler import octree as oc
from f2nerf_torch.train import runner as trun
from f2nerf_torch.train import trainer as ttr
from f2nerf_torch.utils import convert
from f2nerf_torch.utils.parity import STEP_TOL, step_agrees, step_errors
from f2nerf_torch.utils.tree import named_leaves
from test_torch_train_step import jax_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERRIDES = list(TINY_OVERRIDES) + ["+train.fused_adam=true",
                                    "+train.data_parallel=off"]
TREE_FIELDS = ("weight_stats", "alpha_stats", "visit_cnt", "trans_idx")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's intra-op pool
    would oversubscribe the cores (and one thread keeps the CPU sums in
    one order from run to run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------- (a) _chunk_k

def chunk_trainer(cls, chunk, it, milestones, compact, end):
    t = cls.__new__(cls)
    t.chunk_size, t.iter_step, t.compact_freq, t.end_iter = chunk, it, compact, end
    t.tree_host = types.SimpleNamespace(milestones=list(milestones))
    return t


@pytest.mark.parametrize("chunk", [1, 4, 10])
@pytest.mark.parametrize("it", [0, 3, 10, 990, 1000, 1995, 2000, 19990])
def test_chunk_k_matches_jax(chunk, it):
    seen = set()
    for milestones, compact, end, limit in itertools.product(
            ([], [2000, 4000], [5, 1003, 1994]), (1000, 7, 20), (20000, 15, 1004),
            (None, 1, 3, 10, 25)):
        args = (chunk, it, milestones, compact, end)
        want = chunk_trainer(jtr.Trainer, *args)._chunk_k(limit)
        got = chunk_trainer(ttr.Trainer, *args)._chunk_k(limit)
        assert got == want, (args, limit, got, want)
        seen.add(got)
    # every grid with a chunk of more than one iteration reaches both rules
    assert seen == ({1} if chunk == 1 or it % chunk else {1, chunk}), seen


# ------------------------------------------------------- (b) _ingest_aux

CONTROLLER = ("ema_sampled", "ema_meaningful", "ema_oct", "trunc_ema", "oct_max",
              "hit_cap", "sat_ema", "b_trunc_ema", "psnr_smooth", "mse_records")


def controller(cls, frozen):
    t = cls.__new__(cls)
    t.ema_sampled = t.ema_meaningful = 512.0
    t.ema_oct = 16.0
    t.hit_cap_limit, t.hit_cap = 1024, 64
    t.oct_max = t.trunc_ema = t.sat_ema = t.b_trunc_ema = 0.0
    t.controller_frozen = frozen
    t.psnr_smooth = -1.0
    t.mse_records = []
    return t


def metric_series(n=40, seed=0):
    """Host metrics of n steps as both Trainers ingest them: loss terms,
    mse, the finite flag and the render stats, with hit-list peaks and
    truncated rays now and then (so the hit cap grows)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        n_rays = float(rng.choice([512, 1024, 2048]))
        stats = dict(n_sampled=float(rng.integers(1, 200) * n_rays),
                     n_meaningful=float(rng.integers(1, 100) * n_rays),
                     n_oct_hits=float(rng.integers(1, 80) * n_rays),
                     max_oct_hits=float(rng.integers(1, 40 * (1 + i // 10))),
                     overflow_a=float(rng.integers(0, 3) * 1000),
                     overflow_b=float(rng.integers(0, 2) * 500),
                     n_saturated=float(rng.integers(0, 20)),
                     n_trav_truncated=float(rng.integers(0, 4) == 0) * 3.0)
        out.append((int(n_rays), dict(loss=float(rng.uniform(0.05, 0.5)),
                                      mse=float(rng.uniform(1e-4, 5e-2)),
                                      grads_finite=1.0, stats=stats)))
    return out


@pytest.mark.parametrize("frozen", [False, True])
def test_ingest_aux_matches_jax(frozen):
    j, p = controller(jtr.Trainer, frozen), controller(ttr.Trainer, frozen)
    for n_rays, aux in metric_series():
        want = j._ingest_aux(n_rays, dict(aux, stats=dict(aux["stats"])))
        got = p._ingest_aux(n_rays, dict(aux, stats=dict(aux["stats"])))
        assert got == want
    for k in CONTROLLER:
        assert getattr(p, k) == getattr(j, k), k
    assert len(p.mse_records) == 40
    if frozen:
        assert (p.ema_sampled, p.hit_cap, p.oct_max) == (512.0, 64, 0.0)
    else:
        assert p.hit_cap > 64 and p.oct_max > 0


# ------------------------------------------------- (c) the Runners' calls

class RecordingTrainer:
    """Stand-in for the loop surface of both Runners: ``train_auto`` takes
    the port's ``_chunk_k`` rule and records (iteration, k, sync)."""

    def __init__(self, chunk_size, compact_freq=1000, milestones=(), end_iter=20000):
        self.chunk_size, self.compact_freq, self.end_iter = chunk_size, compact_freq, end_iter
        self.tree_host = types.SimpleNamespace(milestones=list(milestones))
        self.iter_step = 0
        self.mse_records = [1e-2]
        self.psnr_smooth = 20.0
        self.trunc_ema = self.sat_ema = self.b_trunc_ema = 0.0
        self.ema_oct = self.ema_sampled = self.ema_meaningful = 1.0
        self.dataset = types.SimpleNamespace(test_set=np.array([], np.int64))
        self.calls, self.saved_at = [], []

    def train_auto(self, sync=True, limit=None):
        k = ttr.Trainer._chunk_k(self, limit)
        self.calls.append((self.iter_step, k, sync))
        self.iter_step += k
        return dict(n_rays=512) if sync else None

    def save_checkpoint(self):
        self.saved_at.append(self.iter_step)


def drive(runner_cls, tmp_path, freqs, end_iter, **trainer_kw):
    r = runner_cls.__new__(runner_cls)
    r.cfg = {}
    os.makedirs(tmp_path, exist_ok=True)
    r.base_exp_dir = str(tmp_path)
    r.trainer = RecordingTrainer(end_iter=end_iter, **trainer_kw)
    r.end_iter = end_iter
    r.report_freq, r.vis_freq, r.stats_freq, r.save_freq = freqs
    r.test_images = lambda: None
    r.train()
    return r.trainer


@pytest.mark.parametrize("freqs,end_iter,trainer_kw", [
    ((10, 20, 20, 30), 40, dict(chunk_size=10)),             # chip_smoke's runner phase
    ((50, 2500, 5000, 20000), 137, dict(chunk_size=10)),     # wanjinyou's cadences
    ((5, 7, 20, 30), 45, dict(chunk_size=5)),
    ((6, 1000, 1000, 8), 30, dict(chunk_size=4, compact_freq=9, milestones=[12, 24])),
    ((2, 1000, 1000, 3), 7, dict(chunk_size=1)),
])
def test_runner_calls_match_jax(tmp_path, monkeypatch, freqs, end_iter, trainer_kw):
    monkeypatch.delenv("F2_JAX_PROFILE", raising=False)
    monkeypatch.delenv("F2_TORCH_PROFILE", raising=False)
    want = drive(jrun.Runner, tmp_path / "jax", freqs, end_iter, **trainer_kw)
    got = drive(trun.Runner, tmp_path / "port", freqs, end_iter, **trainer_kw)
    assert got.calls == want.calls
    assert got.saved_at == want.saved_at
    assert got.iter_step == end_iter
    if trainer_kw["chunk_size"] > 1:
        assert any(k > 1 for _, k, _ in got.calls)


def test_runner_chunks_end_at_the_profile_window(tmp_path, monkeypatch):
    """With F2_TORCH_PROFILE the port's chunks also end at the window's
    edges (30 and 50), so the trace brackets exactly iterations 30-49."""
    monkeypatch.setenv("F2_TORCH_PROFILE", str(tmp_path / "prof"))
    tr = drive(trun.Runner, tmp_path / "port", (1000, 1000, 1000, 1000), 80,
               chunk_size=8)
    starts = [s for s, _, _ in tr.calls]
    assert 30 in starts and 50 in starts, tr.calls
    assert os.listdir(tmp_path / "prof") == ["trace_30_50.json"]
    assert trun.ProfileWindow(None).next_edge(0) is None
    w = trun.ProfileWindow("x", 30, 50)
    assert [w.next_edge(i) for i in (0, 30, 49, 50)] == [30, 50, 50, None]


# ------------------------------------ the Trainers from one start state

@pytest.fixture(scope="module")
def jax_start(tmp_path_factory):
    """A tiny JAX Trainer at iteration 0, its controller frozen, its state
    saved; the octree it built (the port builds the same one,
    tests/test_torch_sampler.py) seeds the port's Trainers below, which
    saves their octree builds."""
    data_dir = write_ball_dataset(str(tmp_path_factory.mktemp("ball")))
    cfg = compose(os.path.join(REPO, "confs"), "wanjinyou", OVERRIDES)
    jt = jtr.Trainer(cfg, str(tmp_path_factory.mktemp("jax")), data_dir, seed=2022)
    jt.freeze_controller()
    jt.save_checkpoint()
    ckpt = os.path.join(jt.base_exp_dir, "checkpoints", "latest")
    with np.load(os.path.join(ckpt, "state.npz")) as z:
        host = convert.octree_from_named(z)
    return dict(cfg=cfg, data_dir=data_dir, jt=jt, ckpt=ckpt, host=host)


@pytest.fixture(scope="module")
def port_state(jax_start, tmp_path_factory):
    """A tiny port Trainer after one step, its controller frozen, its
    state saved; ``restart`` puts it back there (checkpoint, generator,
    hit cap, nothing pending)."""
    pt = ttr.Trainer(jax_start["cfg"], str(tmp_path_factory.mktemp("port")),
                     jax_start["data_dir"], device="cpu", seed=2022,
                     tree_host=copy.deepcopy(jax_start["host"]))
    pt.train_one()
    pt.freeze_controller()
    pt.save_checkpoint()
    gen, hit_cap = pt.generator.get_state(), pt.hit_cap

    def restart():
        pt.load_checkpoint()
        pt.generator.set_state(gen)
        pt.hit_cap = hit_cap
        pt._pending.clear()
        return pt
    return restart


def snapshot(pt) -> dict:
    out = {f"p{k}": v.detach().clone() for k, v in named_leaves(pt.params)}
    out.update({f"o{k}": v.clone() for k, v in named_leaves(pt.opt_state)})
    out.update({f"t{k}": getattr(pt.tree, k).clone() for k in TREE_FIELDS})
    return out


@contextlib.contextmanager
def ingested(pt):
    """Every per-step dict ``_ingest_aux`` returns inside the block, in
    order."""
    seen = []
    real = pt._ingest_aux

    def ingest(n_rays, aux):
        seen.append(dict(real(n_rays, aux)))
        return seen[-1]
    pt._ingest_aux = ingest
    try:
        yield seen
    finally:
        del pt._ingest_aux


STEPS = 4


@pytest.fixture(scope="module")
def synced(port_state):
    """STEPS synced ``train_one`` calls from the start state: what each
    returned, what each ingested, the MSE records and the end state."""
    pt = port_state()
    n0 = len(pt.mse_records)
    with ingested(pt) as seen:
        outs = [pt.train_one(sync=True) for _ in range(STEPS)]
    return dict(outs=outs, seen=seen, mse=pt.mse_records[n0:], state=snapshot(pt),
                iter=pt.iter_step)


def test_train_many_equals_train_one_bit_for_bit(port_state, synced):
    pt = port_state()
    n0 = len(pt.mse_records)
    with ingested(pt) as seen:
        last = pt.train_many(STEPS)
    assert pt.iter_step == synced["iter"] and not pt._pending
    state = snapshot(pt)
    assert set(state) == set(synced["state"])
    for name, want in synced["state"].items():
        assert torch.equal(state[name], want), name
    assert seen == synced["seen"]
    assert pt.mse_records[n0:] == synced["mse"]
    assert last == synced["outs"][-1]
    assert last["cap1"] >= last["cap2"] and last["hit_cap"] == pt.hit_cap


def test_pipelined_fetch_ingests_the_synced_series(port_state, synced):
    pt = port_state()
    with ingested(pt) as seen:
        outs = [pt.train_one(sync=False) for _ in range(STEPS)]
        depth = pt.pipeline_depth
        assert outs[:depth] == [None] * depth
        # each later call drains the oldest step: its own metrics come back
        assert outs[depth:] == synced["outs"][:STEPS - depth]
        assert len(pt._pending) == depth
        assert pt._drain(sync=True) == synced["outs"][-1]
    assert seen == synced["seen"] and not pt._pending

    # the statics a drained step reports are those it ran with
    pt = port_state()
    caps = [64, 128, 64, 128]
    outs = []
    for c in caps:
        pt.hit_cap = c
        outs.append(pt.train_one(sync=False))
    assert outs[-1]["hit_cap"] == caps[0] and pt.hit_cap == caps[-1]
    assert pt._drain(sync=True)["hit_cap"] == caps[-1]


# ------------------------------------------- (e) against JAX's scan chunk

def test_train_many_matches_jax_chunk(jax_start, tmp_path):
    """Two chunked steps from one checkpoint with the draws JAX's chunk
    makes from its two keys. The state after the chunk is held to
    STEP_TOL with the Adam first moments standing for the gradients and
    the two steps' learning rates summed as the step bound's unit (an
    entry moves by up to one step in each)."""
    k = 2
    jt, cfg = jax_start["jt"], jax_start["cfg"]
    n_rays = jt.cur_batch_size()
    step_fn, st = jt._get_step(n_rays, chunk=k)
    tcfg = cfg["train"]
    its = range(jt.iter_step, jt.iter_step + k)
    runtimes = {name: jnp.asarray([f(i, tcfg) for i in its], jnp.float32) for name, f in (
        ("lr", schedules.learning_rate), ("fineness", schedules.ray_march_fineness),
        ("grad_progress", schedules.gradient_scaling_progress),
        ("var_loss_weight", schedules.var_loss_weight))}
    keys = jax.random.split(jax.random.PRNGKey(321), k)
    draws = [jax_draws(keys[i], n_rays, st, jt.data["train_ids"].shape[0],
                       jt.dataset.height, jt.dataset.width, jt.tree_host.edge_t.shape[0])
             for i in range(k)]
    p_j, o_j, tree_j, aux_j = step_fn(jt.params, jt.opt_state, jt.tree, jt.consts,
                                      jt.data, keys, runtimes, n_rays)

    pt = ttr.Trainer(cfg, str(tmp_path / "port"), jax_start["data_dir"], device="cpu",
                     tree_host=copy.deepcopy(jax_start["host"]))
    pt.load_checkpoint(jax_start["ckpt"])
    pt.hit_cap, pt._cur_bucket = jt.hit_cap, jt._cur_bucket
    pt._cap_memo = dict(jt._cap_memo)
    pt.freeze_controller()
    assert pt.cur_batch_size() == n_rays
    st_p = pt._get_step(n_rays)[1]
    for f in ("max_s", "cap1", "cap2", "max_hits", "single_pass", "n_edge"):
        assert getattr(st_p, f) == getattr(st, f), f
    with ingested(pt) as seen:
        pt.train_many(k, draws=draws)
    assert pt.iter_step == k and len(seen) == k

    for i in range(k):
        want = float(aux_j["loss"][i])
        assert seen[i]["loss"] == pytest.approx(want, rel=STEP_TOL["loss_rtol"]), i
    for name in ("n_sampled", "n_meaningful", "n_oct_hits", "max_oct_hits"):
        assert seen[0][name] == float(aux_j["stats"][name][0]), name
    params_j = dict(named_leaves(jax.tree_util.tree_map(np.asarray, p_j)))
    mu_j = dict(named_leaves(jax.tree_util.tree_map(np.asarray, o_j[1].mu)))
    mu_p = {n: v.numpy() for n, v in named_leaves(pt.opt_state["mu"])}
    occ_j = {f: np.asarray(getattr(tree_j, f)) for f in TREE_FIELDS}
    occ_p = {f: getattr(pt.tree, f).numpy() for f in TREE_FIELDS}
    err = step_errors(seen[-1]["loss"], float(aux_j["loss"][-1]), mu_p, mu_j,
                      {n: v.detach().numpy() for n, v in named_leaves(pt.params)},
                      params_j, occ_p, occ_j, float(np.sum(runtimes["lr"])))
    assert step_agrees(err), err
    assert int(pt.opt_state["count"]) == int(o_j[1].count) == k


# --------------------------------------------------------- (g) the bench

def test_bench_runs_on_the_cpu_with_bench_py_keys(jax_start, monkeypatch):
    """The bench's steps on the CPU, one iteration each (+train.step_chunk=1):
    the JSON line's keys. Its ball scene's octree is the one built above
    (the same scene and config), which saves the build."""
    monkeypatch.setenv("F2_BENCH_SYNTH", "1")
    monkeypatch.setenv("F2_BENCH_CKPT", "0")
    monkeypatch.setattr(oc, "build_octree",
                        lambda *a, **kw: copy.deepcopy(jax_start["host"]))
    out = bench.run_bench(overrides=list(TINY_OVERRIDES) + ["+train.step_chunk=1"],
                          settle=1, timed_steps=1, device="cpu")
    assert set(out) == {"metric", "value", "unit", "vs_baseline"}
    assert out["metric"] == "synthetic-ball wanjinyou training throughput"
    assert out["unit"] == "rays/sec" and out["value"] > 0
    assert out["vs_baseline"] == round(out["value"] / bench.BASELINE_RAYS_PER_SEC, 4)


def test_bench_imports_no_jax_and_refuses_cuda_without_a_card():
    code = ("import f2nerf_torch.bench, f2nerf_torch.run, sys; "
            "assert 'jax' not in sys.modules and 'f2nerf_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main([])
