"""The port's spans (``f2nerf_torch/utils/spans.py``) and their host table:
nothing is recorded while collection is off; self time is total less the
child spans of the same thread, across ``Spans`` instances; a training
chunk, a whole-image render and a Trainer build record the spans the
program puts around its host work, each family consecutive. CPU, at
TINY_OVERRIDES."""

import json
import math
import os
import threading
import time

import numpy as np
import pytest
import torch

from f2nerf_torch import native
from f2nerf_torch.data import dataset as ds
from f2nerf_torch.train import trainer as ttr
from f2nerf_torch.utils import spans
from f2nerf_torch.utils.config import compose
from f2nerf_torch.utils.synthetic import TINY_OVERRIDES, write_ball_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERRIDES = list(TINY_OVERRIDES) + ["+train.data_parallel=off"]
STEP_SPANS = ("step.draw", "step.sample_rays", "step.render", "step.losses",
              "step.backward", "step.occupancy_fold", "step.adam", "step.metrics_row")
CHUNK_SPANS = ("step.controller", "step.drain")
RENDER_SPANS = ("render.traverse", "render.march", "render.compact_a_warp",
                "render.prefilter", "render.compact_b", "render.field_shader",
                "render.composite")
SETUP_SPANS = ("setup.dataset", "setup.octree", "setup.device_tree", "setup.params")
FAMILIES = (("step.", "eval."), ("render.",))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's intra-op pool
    would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def collecting():
    was = spans.collect(True)
    yield
    spans.collect(was)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    data_dir = write_ball_dataset(str(tmp_path_factory.mktemp("ball")))
    cfg = compose(os.path.join(REPO, "confs"), "wanjinyou", OVERRIDES)
    return dict(cfg=cfg, data_dir=data_dir, exp=str(tmp_path_factory.mktemp("exp")))


@pytest.fixture(scope="module")
def trainer(setup):
    tr = ttr.Trainer(setup["cfg"], setup["exp"], setup["data_dir"], device="cpu")
    tr.train_many(2, sync=True)          # the chunk's step is built
    return tr


def recorded(fn):
    before = spans.snapshot()
    out = fn()
    return spans.diff(spans.snapshot(), before), out


def assert_consecutive(table: dict) -> None:
    """No span of a family holds another of the same family."""
    for name, rec in table.items():
        for fam in FAMILIES:
            if name.startswith(fam):
                assert not (rec["parent"] or "").startswith(fam), (name, rec)


def test_collection_off_records_nothing():
    was = spans.collect(False)
    try:
        def work():
            s = spans.Spans()
            s("test.off_a")
            assert spans.current() is None
            s("test.off_b")
            s.close()
            with spans.span("test.off_c"):
                pass
        table, _ = recorded(work)
    finally:
        spans.collect(was)
    assert table == {}


def test_self_time_is_total_less_children(collecting):
    outer, inner = spans.Spans(), spans.Spans()
    seen = {}

    def work():
        outer("test.outer")
        time.sleep(0.01)
        inner("test.inner")                 # another instance, the same stack
        time.sleep(0.02)
        seen["main"] = spans.current()

        def other():
            seen["other_before"] = spans.current()
            with spans.span("test.other"):
                time.sleep(0.01)
        t = threading.Thread(target=other)
        t.start()
        t.join()
        inner.close()
        seen["after_inner"] = spans.current()
        time.sleep(0.01)
        outer.close()
    table, _ = recorded(work)
    o, i, t = table["test.outer"], table["test.inner"], table["test.other"]
    assert seen == dict(main="test.inner", other_before=None, after_inner="test.outer")
    assert o["count"] == i["count"] == t["count"] == 1
    assert i["parent"] == "test.outer" and o["parent"] is None
    # the other thread's span is on a stack of its own: no parent, not
    # the main thread's top level, not a child of test.inner
    assert t["parent"] is None and t["top_ns"] == 0 and t["total_ns"] >= 10e6
    assert i["self_ns"] == i["total_ns"] >= 20e6
    assert o["self_ns"] == o["total_ns"] - i["total_ns"] >= 20e6
    assert o["top_ns"] == o["total_ns"] and i["top_ns"] == 0


def test_table_loses_no_entry_across_threads(collecting):
    """Threads closing spans of one name at once (more threads than
    cores, a short switch interval): every entry counted once, each
    thread's spans on its own stack."""
    import sys
    n_threads, n_spans = 3 * (os.cpu_count() or 4), 400
    interval = sys.getswitchinterval()

    def work():
        s = spans.Spans()
        for _ in range(n_spans):
            s("test.threads")
            with spans.span("test.threads_inner"):
                pass
        s.close()
    sys.setswitchinterval(1e-6)
    try:
        before = spans.snapshot()
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        table = spans.diff(spans.snapshot(), before)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    outer, inner = table["test.threads"], table["test.threads_inner"]
    assert outer["count"] == inner["count"] == n_threads * n_spans
    assert inner["parent"] == "test.threads" and outer["parent"] is None
    assert outer["self_ns"] == outer["total_ns"] - inner["total_ns"]
    assert outer["top_ns"] == 0            # none of them on the main thread


def test_train_many_records_every_span(trainer, collecting):
    table, _ = recorded(lambda: trainer.train_many(2, sync=True))
    for name in STEP_SPANS + RENDER_SPANS:
        assert table.get(name, {}).get("count") == 2, (name, table.get(name))
    for name in CHUNK_SPANS:
        assert table.get(name, {}).get("count") == 1, (name, table.get(name))
    for name in RENDER_SPANS:
        assert table[name]["parent"] == "step.render"
    # the backward's nodes, inside step.backward on the CPU's one thread
    for name in ("backward.field", "backward.segment"):
        assert table[name]["count"] >= 2 and table[name]["parent"] == "step.backward"
    assert "build.step" not in table and "step.maintain" not in table
    assert_consecutive(table)
    for rec in table.values():
        assert 0 <= rec["self_ns"] <= rec["total_ns"]
    # the trainer's step.render less the renderer's spans inside it
    for outer in ("step.render", "step.backward"):
        inner = sum(r["total_ns"] for r in table.values() if r["parent"] == outer)
        assert inner > 0 and table[outer]["self_ns"] == table[outer]["total_ns"] - inner
    top = sum(r["top_ns"] for r in table.values())
    assert top == sum(table[n]["total_ns"] for n in STEP_SPANS + CHUNK_SPANS
                      if table[n]["parent"] is None)


def test_build_step_counts_new_cache_keys(trainer, collecting):
    n_rays = trainer.cur_batch_size()
    trainer._step_cache.clear()
    first, _ = recorded(lambda: trainer._get_step(n_rays))
    again, _ = recorded(lambda: trainer._get_step(n_rays))
    other, _ = recorded(lambda: trainer._get_step(2 * n_rays))
    assert first["build.step"]["count"] == 1
    assert "build.step" not in again
    assert other["build.step"]["count"] == 1


def test_trainer_build_records_setup_spans(setup, tmp_path, monkeypatch, collecting):
    monkeypatch.setattr(native._state, "lib", None)      # loaded again, once
    table, tr = recorded(lambda: ttr.Trainer(setup["cfg"], str(tmp_path), setup["data_dir"],
                                             device="cpu"))
    for name in SETUP_SPANS:
        assert table.get(name, {}).get("count") == 1, (name, table.get(name))
        assert table[name]["parent"] is None
    assert table["setup.kernels"]["count"] == 1
    assert table["setup.kernels"]["parent"] in SETUP_SPANS
    assert tr.iter_step == 0


def test_maintain_span_past_the_early_return(trainer, collecting):
    skipped, _ = recorded(trainer.maybe_maintain_tree)
    assert "step.maintain" not in skipped
    it, compact = trainer.iter_step, trainer.compact_freq
    trainer.iter_step = compact * (it // compact + 1)
    try:
        ran, _ = recorded(trainer.maybe_maintain_tree)
    finally:
        trainer.iter_step = it
    assert ran["step.maintain"]["count"] == 1


@pytest.mark.parametrize("max_s", [512, 8])
def test_image_render_counts_chunks_and_redo(trainer, collecting, max_s):
    h, w = trainer.dataset.height, trainer.dataset.width
    ro, rd = ds.camera_rays(trainer.data, 0, h, w)
    chunk = 512
    table, (colors, _, _) = recorded(
        lambda: trainer.render_image(ro, rd, chunk=chunk, max_s=max_s, max_s_hi=512))
    assert np.isfinite(colors).all()
    assert table["image.render"]["count"] == 1
    assert table["eval.chunk"]["count"] == math.ceil(h * w / chunk)
    assert table.get("eval.chunk_exact", {}).get("count", 0) == len(trainer.last_redo)
    assert bool(trainer.last_redo) == (max_s == 8)
    for name in ("eval.chunk", "eval.chunk_exact"):
        if name in table:
            assert table[name]["parent"] == "image.render"
    for name in RENDER_SPANS:
        if name in table:
            assert table[name]["parent"] in ("eval.chunk", "eval.chunk_exact")
    assert_consecutive(table)


def test_profile_window_prints_host_ms_by_span(tmp_path, capsys):
    from f2nerf_torch.train import runner as trun
    was = spans.collect(False)
    try:
        w = trun.ProfileWindow(str(tmp_path / "prof"), start=1, stop=3)
        for it in range(4):
            w.at(it)
            with spans.span("test.window"):
                torch.ones(8).sum()
            if it == 1:
                assert spans.collect(False) is True     # collecting inside the window
                spans.collect(True)
        assert spans.collect(False) is False            # restored at the close
    finally:
        spans.collect(was)
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if "host ms an iteration by span" in ln)
    row = json.loads(line.split(": ", 1)[1])["test.window"]
    assert row[2] == 2 and row[3] is None and 0 < row[1] <= row[0]
    assert sorted(os.listdir(tmp_path / "prof")) == ["trace_1_3.json"]
