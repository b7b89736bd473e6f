"""The check that decides ``correct``, at a size a test run holds
(``tiny.py``): the program agrees with the reference within each limit,
the control (the reference with its field in bfloat16) fails a limit, and
a run whose timed path is broken underneath reads ``correct`` false, once
for each fault a cell can have. The CPU runs the kernels' plain versions;
the ``cuda``-marked case takes the same readings on the card at the
cell's own size (a minute or two a case).

    python -m pytest cellbench -q            # here
    python -m pytest cellbench -q -m cuda    # on the card
"""

from __future__ import annotations

import tempfile
import time

import pytest
import torch

from cellbench import control, manifest
from cellbench.run import run_cell
from cellbench.tiny import ROOT, tiny_pair

# every cell's (configuration, traffic), and the render mode that no cell
# runs yet (PERF.md, Open questions), so a later cell finds it sound
PAIRS = sorted({(w["config"], w["traffic"]) for w in manifest.benchmark(ROOT)["workloads"]}
               | {("wanjinyou-hashblock", "render-views")})
IDS = [f"{c}.{t}" for c, t in PAIRS]
SEED = (1 << 31) + 4099


def fast(mix: dict) -> dict:
    return dict(mix, settle=dict(min_steps=10, max_steps=10, stable_chunks=1))


def check_readings(doc: dict, mix: dict, pair: tuple, device: str, seconds: float) -> None:
    r = control.readings(".".join(pair), SEED, seconds, device, doc, mix)
    limits = doc["limits"][mix["mode"]]
    assert all(r["program"][k] <= limits[k] for k in limits), (r, limits)
    assert any(r["control"][k] > limits[k] for k in limits), (r, limits)


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_program_within_limits_control_beyond(pair, monkeypatch):
    monkeypatch.chdir(ROOT)
    doc, mix = tiny_pair(*pair)
    check_readings(doc, fast(mix), pair, "cpu", 0.2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_program_within_limits_control_beyond_on_card(pair, card, monkeypatch):
    """At the cell's own size, which the limits were set at."""
    monkeypatch.chdir(ROOT)
    check_readings(manifest.config(pair[0]), manifest.mix(pair[1]), pair, card, 2.0)


# ---------------------------------------------------------------- faults

def _unchanged_state(monkeypatch, tm):
    """A step that returns its state unchanged: Adam never writes."""
    monkeypatch.setattr(tm, "apply_adam", lambda *a, **k: None)


def _half_batch(monkeypatch, tm):
    """Half of the batch left out of the colour loss, the mean over the rest."""
    orig = tm.compute_losses

    def half(result, gt, n_rays, w, rt):
        h = n_rays // 2
        part = dict(result, colors=result["colors"][:h], disparity=result["disparity"][:h])
        return orig(part, gt[:h], n_rays, w, rt)
    monkeypatch.setattr(tm, "compute_losses", half)


def _fold_never_writes(monkeypatch, tm):
    """The occupancy fold returns the tree it was given."""
    monkeypatch.setattr(tm.dv, "apply_occupancy_adders", lambda tree, occ: tree)


def _rope_altered(monkeypatch, tm):
    """The device packing writes one leaf's rope wrong (in its record too)."""
    import dataclasses
    orig = tm.dv.to_device_tree

    def packed(*a, **k):
        t = orig(*a, **k)
        u = int(torch.nonzero(t.is_leaf[:t.n_nodes])[0, 0])
        rope, rec = t.rope.clone(), t.node_rec.clone()
        rope[u, 0] = rec[u, 12] = -1 if int(rope[u, 0]) != -1 else 0
        return dataclasses.replace(t, rope=rope, node_rec=rec)
    monkeypatch.setattr(tm.dv, "to_device_tree", packed)


def _render_fault(monkeypatch, tm, alter):
    orig = tm.make_render_fn

    def make(st):
        fn = orig(st)

        def broken(*a):
            colors, disp, oct_d, trunc = fn(*a)
            return alter(colors.clone()), disp, oct_d, trunc
        return broken
    monkeypatch.setattr(tm, "make_render_fn", make)


def _altered_answer(monkeypatch, tm):
    """Every 8th ray's colour altered where the chunk produces it."""
    def alter(c):
        c[::8] += 0.01
        return c
    _render_fault(monkeypatch, tm, alter)


def _half_chunk(monkeypatch, tm):
    """The second half of each chunk left out (background in its place)."""
    def alter(c):
        c[c.shape[0] // 2:] = 0.5
        return c
    _render_fault(monkeypatch, tm, alter)


HB, AN = "wanjinyou-hashblock", "wanjinyou-anchored"
FAULTS = [((HB, "train-late"), _unchanged_state),
          ((HB, "train-late"), _half_batch),
          ((HB, "train-late"), _fold_never_writes),
          ((HB, "train-late"), _rope_altered),
          ((AN, "train-late"), _unchanged_state),
          ((AN, "train-late"), _fold_never_writes),
          ((HB, "render-views"), _altered_answer),
          ((HB, "render-views"), _half_chunk)]


@pytest.mark.parametrize("pair,fault", FAULTS,
                         ids=[f"{c}.{t}-{f.__name__[1:]}" for (c, t), f in FAULTS])
def test_broken_path_reads_incorrect(pair, fault, monkeypatch):
    from f2nerf_torch.train import trainer as tm
    monkeypatch.chdir(ROOT)
    doc, mix = tiny_pair(*pair)
    fault(monkeypatch, tm)
    with tempfile.TemporaryDirectory() as tmp:
        out = run_cell(".".join(pair), doc, fast(mix), manifest.benchmark(ROOT), SEED, 0.2,
                       False, "cpu", tmp, time.perf_counter())
    assert out["correct"] is False, out["compared"]


@pytest.mark.parametrize("field", ["HashBlock", "Hash3DAnchored"])
def test_weights_are_the_configurations_init(field):
    """The benchmark's weights and hash constants (primes found on the
    device) are what the frozen copies' init draws from the same stream."""
    from cellbench.reference import hash_block, hash_encoding, step
    cfg = manifest.config("wanjinyou-hashblock")["config"]
    cfg = dict(cfg, field=dict(cfg["field"], type=field, log2_table_size=12))
    params, consts = step.init_params(torch.Generator().manual_seed(SEED), cfg, 24, 40)
    init = hash_block.init_block_state if field == "HashBlock" else hash_encoding.init_hash_state
    feat, prim, bias = init(torch.Generator().manual_seed(SEED), 12, 40, True)
    assert torch.equal(params["feat_pool"].detach(), feat)
    assert torch.equal(consts["prim_pool"], prim) and torch.equal(consts["bias_pool"], bias)
