"""Nothing the harness loads is JAX or the JAX package, and the reference
loads nothing of the port. Top-level module names (before the first dot)
are compared whole: the port's name begins with the JAX package's. CPU
only."""

from __future__ import annotations

import subprocess
import sys

from cellbench.run import FORBIDDEN, forbidden_modules
from cellbench.tiny import ROOT

HARNESS = ("cellbench.run", "cellbench.cell", "cellbench.control", "cellbench.trace",
           "cellbench.counts", "cellbench.manifest", "cellbench.scene",
           "f2nerf_torch.train.trainer")


def loaded_after(imports, extra: str = "") -> set:
    code = ("import sys\n" + "".join(f"import {m}\n" for m in imports) + extra
            + "print('\\n'.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    mods = loaded_after(HARNESS, "from cellbench import manifest\n"
                        "[manifest.reader(m['name']) for m in "
                        "manifest.benchmark('.')['per_layer']]\n")
    assert not {m for m in mods if m.split(".")[0] in FORBIDDEN}
    assert "f2nerf_torch" in mods


def test_reference_loads_nothing_of_the_port():
    mods = loaded_after(("cellbench.reference.step", "cellbench.reference.data",
                         "cellbench.counts"))
    assert not {m for m in mods if m.split(".")[0] in FORBIDDEN + ("f2nerf_torch",)}


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    for name in ("jaxlike", "f2nerf_tpu_x", "f2nerf_torch.fields"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "f2nerf_tpu.ops", sys)
    assert forbidden_modules() == ["f2nerf_tpu.ops", "jax.numpy"]
