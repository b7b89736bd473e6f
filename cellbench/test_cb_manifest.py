"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name. CPU only: python -m pytest cellbench -q"""

from __future__ import annotations

import json
import os
import re

import pytest

from cellbench import manifest
from cellbench.tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def bench():
    return manifest.benchmark(ROOT)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p.split("/")
        assert not p.startswith("/") and os.path.isdir(os.path.join(ROOT, p))
    assert len(bench["command"]) <= 32
    for word in bench["command"]:
        assert TEXT.match(word) and not word.startswith("/")


def test_names_units_and_entry_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        names.append(w["name"])
    for section, extra in (("end_to_end", {"bound"}), ("per_layer", {"layer", "moves"})):
        for m in bench[section]:
            assert set(m) - {"workloads"} == {"name", "unit", "better", "source"} | extra
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
            names.append(m["name"])
    assert len(names) == len(set(names))
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_files_found_by_name(bench):
    for c in bench["configs"]:
        assert c["file"] == f"cellbench/configs/{c['name']}.json"
        doc = manifest.config(c["name"])
        assert doc["name"] == c["name"] and doc["source"] == c["source"]
        assert sorted(doc["reduced"]) == sorted(c["reduced"])
    for w in bench["workloads"]:
        assert any(c["name"] == w["config"] for c in bench["configs"])
        assert manifest.mix(w["traffic"])["mode"] in ("train", "render")
    for m in bench["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_each_metric_moves_a_metric_its_cells_report(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for cell in cells:
        reported = [m["name"] for m in manifest.metrics_for(bench, "end_to_end", cell)]
        assert "setup_s" in reported and len(reported) >= 2
        assert manifest.metrics_for(bench, "per_layer", cell)
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
        assert TEXT.match(m["layer"])


def test_every_config_and_pair_used_once(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(pairs) // 4)


def test_limits_cover_what_the_check_compares(bench):
    keys = {"train": {"loss_gap", "grad_gap", "change_gap", "fold_mismatch", "tree_mismatch"},
            "render": {"color_gap", "disparity_gap", "tree_mismatch"}}
    for w in bench["workloads"]:
        mode = manifest.mix(w["traffic"])["mode"]
        limits = manifest.config(w["config"])["limits"][mode]
        assert set(limits) == keys[mode]
        assert all(v >= 0 for v in limits.values())


def test_json_round_trip(bench):
    text = open(os.path.join(ROOT, "BENCHMARK.json")).read()
    assert json.loads(text) == bench
