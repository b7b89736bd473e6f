"""Drive the port's main path (f2nerf_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase; needs one CUDA card
    python3 chip_smoke.py --phases build,kernels   # a subset (no final line)

Phases:
  1. device  — refuse to run without CUDA; print the card and its power limit.
  2. build   — compile the hand-written kernels from f2nerf_torch/csrc/.
  3. kernels — each kernel against its plain PyTorch version on the card at
               the slice's shapes: max error against the stated tolerance and
               the median time of both (CUDA events).
  4. slice   — the ball scene, confs/wanjinyou.yaml at full width with
               +train.fused_adam=true, 20 Trainer.train_one steps on the card;
               losses finite, grads finite, params moved, every kernel
               launched by the main path (launch counters reset just before).
  5. parity  — one step from one saved state with one set of draws on the
               card (kernels) and on the CPU (plain versions), compared.
  profile    — not run by default: torch.profiler over 3 more slice steps,
               per-span host/device time and the top kernels
               (--phases device,build,kernels,slice,profile).

The last lines are the kernels JSON, the card line, and the result JSON.
Any failed phase raises, and the script exits non-zero without a result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
N_STEPS = 20
TIME_FROM = 4          # steps 4..20 are timed (the first ones warm up)

# K1/K2 tolerances: the kernel and its plain version do the same f32
# operations in the same order (K2 rounds its index math per operation),
# so they agree to a few ulps. K3 sums with atomics in no fixed order: the
# error grows with the number of terms per table entry, so it is held
# relative to the largest gradient magnitude.
TOL_ADAM = 1e-6
TOL_ENCODE = 1e-6
TOL_SCATTER_REL = 1e-5


def log(*a):
    print(*a, flush=True)


def cuda_time(fn, reps: int = 10) -> float:
    """Median milliseconds of fn() over reps, CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


# ------------------------------------------------------------------ phases

def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this script "
                           "runs only on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"nvidia-smi: {smi}")
    return dict(name=name, smi=smi, count=torch.cuda.device_count())


def phase_build() -> None:
    from f2nerf_torch import kernels
    t0 = time.perf_counter()
    kernels.library()
    info = kernels.build_info()
    log(f"[build] {len(kernels.sources())} sources -> {kernels.library_path().name} "
        f"in {time.perf_counter() - t0:.2f} s (nvcc {info['seconds']} s)")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("[build] " + line.strip())


def _adam_case(dev, gen):
    """The slice's leaves: the [16, 16384, 128] pool plus the MLP/app_emb
    leaves of wanjinyou (field 32-64-64-16, shader 32-64-64-64-3)."""
    shapes = [(16, 16384, 128), (32, 64), (64, 64), (64, 16), (32, 64),
              (64, 64), (64, 64), (64, 3), (24, 16)]
    out = []
    for k, s in enumerate(shapes):
        def r(scale):
            return torch.randn(s, generator=gen, device=dev) * scale
        out.append(dict(p=r(1e-2), m=r(1e-3), v=r(1e-3).abs(), g=r(1e-3),
                        wd=0.0 if k == 0 else 1e-6))
    return out


def phase_kernels() -> list[dict]:
    from f2nerf_torch.fields import hash_block as hb
    from f2nerf_torch.fields.hash_encoding import _random_primes
    from f2nerf_torch.ops import fused_adam as fa
    from f2nerf_torch.train.trainer import ADAM_KW

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    # ---- K1 fused Adam over every leaf
    scal = torch.tensor([1e-2, 1.0 / (1 - 0.9 ** 3), 1.0 / (1 - 0.99 ** 3)],
                        dtype=torch.float32, device=dev)
    yes = torch.ones((), dtype=torch.bool, device=dev)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    err = 0.0
    for leaf in _adam_case(dev, gen):
        a = {k: v.clone() for k, v in leaf.items() if k != "wd"}
        b = {k: v.clone() for k, v in leaf.items() if k != "wd"}
        fa.fused_adam(a["p"], a["m"], a["v"], a["g"], scal, yes, wd=leaf["wd"], **ADAM_KW)
        fa.adam_leaf_plain(b["p"], b["m"], b["v"], b["g"], scal, yes, wd=leaf["wd"], **ADAM_KW)
        err = max(err, *((a[k] - b[k]).abs().max().item() for k in "pmv"))
        c = {k: v.clone() for k, v in leaf.items() if k != "wd"}
        fa.fused_adam(c["p"], c["m"], c["v"], c["g"], scal, no, wd=leaf["wd"], **ADAM_KW)
        if not all(torch.equal(c[k], leaf[k]) for k in "pmv"):
            raise AssertionError("fused_adam wrote on a skipped (non-finite) step")
    torch.cuda.synchronize()
    pool = {k: v.clone() for k, v in _adam_case(dev, gen)[0].items() if k != "wd"}
    ms = cuda_time(lambda: fa.fused_adam(pool["p"], pool["m"], pool["v"], pool["g"],
                                         scal, yes, wd=0.0, **ADAM_KW))
    plain_ms = cuda_time(lambda: fa.adam_leaf_plain(pool["p"], pool["m"], pool["v"],
                                                    pool["g"], scal, yes, wd=0.0, **ADAM_KW))
    log(f"[kernels] K1 fused_adam: max_abs_err {err:.3e} (tol {TOL_ADAM:g}); "
        f"pool [16,16384,128]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
        f"(memory bound: 0.94 GB -> 0.28 ms at 3.35 TB/s)")
    if not err <= TOL_ADAM:
        raise AssertionError(f"fused_adam disagrees with its plain version: {err}")
    rows.append(dict(name="fused_adam", route="cuda",
                     source="f2nerf_torch/csrc/fused_adam.cu",
                     replaces="f2nerf_tpu/ops/fused_adam.py:71",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms))

    # ---- K2 / K3 at the slice's cap1: 393,216 samples, 431 volumes, 2^19
    n, nv, l2t = 393216, 431, 19
    nb = hb.n_blocks(l2t)
    feat = torch.randn((16, nb, 128), generator=gen, device=dev)
    seeds = torch.randint(1 << 28, 1 << 30, (16 * nv * 3,), generator=gen, device=dev)
    prim = torch.from_numpy(_random_primes(seeds.cpu().numpy()).astype(np.int32)
                            .reshape(16, nv, 3)).to(dev)
    bias = torch.rand((16, nv, 3), generator=gen, device=dev) * 1000.0 + 100.0
    pts = torch.rand((n, 3), generator=gen, device=dev)
    vol = torch.randint(0, nv, (n,), generator=gen, device=dev).to(torch.int32)
    g = torch.randn((n, 32), generator=gen, device=dev)

    out_k = hb.hash_block_fwd(feat, prim, bias, pts, vol, l2t)
    out_p = hb.hash_block_fwd_plain(feat, prim, bias, pts, vol, l2t)
    err2 = (out_k - out_p).abs().max().item()
    ms2 = cuda_time(lambda: hb.hash_block_fwd(feat, prim, bias, pts, vol, l2t))
    plain2 = cuda_time(lambda: hb.hash_block_fwd_plain(feat, prim, bias, pts, vol, l2t))
    log(f"[kernels] K2 hash_block_fwd n={n}: max_abs_err {err2:.3e} (tol {TOL_ENCODE:g}); "
        f"kernel {ms2:.4f} ms, plain {plain2:.4f} ms")
    if not (np.isfinite(err2) and err2 <= TOL_ENCODE):
        raise AssertionError(f"hash_block_fwd disagrees with its plain version: {err2}")
    rows.append(dict(name="hash_block_fwd", route="cuda",
                     source="f2nerf_torch/csrc/hash_block.cu",
                     replaces="f2nerf_tpu/fields/hash_block.py:153",
                     max_abs_err=err2, ms=ms2, plain_ms=plain2))

    shape = tuple(feat.shape)
    d_k = hb.hash_block_bwd(g, prim, bias, pts, vol, l2t, shape)
    d_p = hb.hash_block_bwd_plain(g, prim, bias, pts, vol, l2t, shape)
    err3 = (d_k - d_p).abs().max().item()
    scale3 = d_p.abs().max().item()
    ms3 = cuda_time(lambda: hb.hash_block_bwd(g, prim, bias, pts, vol, l2t, shape))
    plain3 = cuda_time(lambda: hb.hash_block_bwd_plain(g, prim, bias, pts, vol, l2t, shape))
    log(f"[kernels] K3 hash_block_bwd n={n}: max_abs_err {err3:.3e} "
        f"(tol {TOL_SCATTER_REL:g} x max|grad| {scale3:.3e}); "
        f"kernel {ms3:.4f} ms, plain {plain3:.4f} ms")
    if not (np.isfinite(err3) and err3 <= TOL_SCATTER_REL * scale3):
        raise AssertionError(f"hash_block_bwd disagrees with its plain version: {err3}")
    rows.append(dict(name="hash_block_bwd", route="cuda",
                     source="f2nerf_torch/csrc/hash_block.cu",
                     replaces="f2nerf_tpu/fields/hash_block.py:191",
                     max_abs_err=err3, ms=ms3, plain_ms=plain3))
    return rows


def _compose():
    from f2nerf_torch.utils.config import compose
    return compose(os.path.join(REPO, "confs"), "wanjinyou",
                   ["+train.fused_adam=true"])


def phase_slice(tmp: str) -> tuple[dict, object]:
    from f2nerf_torch.fields import hash_block as hb
    from f2nerf_torch.ops import fused_adam as fa
    from f2nerf_torch.train.trainer import Trainer
    from f2nerf_torch.utils.synthetic import write_ball_dataset
    from f2nerf_torch.utils.tree import named_leaves

    data_dir = write_ball_dataset(os.path.join(tmp, "ball"))
    cfg = _compose()
    t0 = time.perf_counter()
    tr = Trainer(cfg, os.path.join(tmp, "exp"), data_dir, seed=2022, device="cuda")
    torch.cuda.synchronize()
    t_host = tr.tree_host
    log(f"[slice] Trainer built in {time.perf_counter() - t0:.2f} s: "
        f"{t_host.n_nodes} nodes, {t_host.n_trans} volumes, "
        f"{int(t_host.is_leaf.sum())} leaves, {t_host.edge_t.shape[0]} edges; "
        f"feat_pool {tuple(tr.params['feat_pool'].shape)}")
    p0 = {k: v.detach().clone() for k, v in named_leaves(tr.params)}
    n_leaves = len(p0)

    wrappers = (fa.fused_adam, hb.hash_block_fwd, hb.hash_block_bwd)
    for w in wrappers:
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    rays = 0
    t_start = None
    for step in range(1, N_STEPS + 1):
        if step == TIME_FROM:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        m = tr.train_one()
        if step >= TIME_FROM:
            rays += m["n_rays"]
        log(f"[slice] step {step}: n_rays {m['n_rays']} cap1 {m['cap1']} "
            f"cap2 {m['cap2']} hit_cap {m['hit_cap']} loss {m['loss']:.6f} "
            f"traverse_iters {m['trav_iters']} sampled {m['n_sampled']:.0f} "
            f"meaningful {m['n_meaningful']:.0f} grads_finite {m['grads_finite']:.0f}")
        if not np.isfinite(m["loss"]):
            raise AssertionError(f"non-finite loss at step {step}")
        if m["grads_finite"] != 1.0:
            raise AssertionError(f"non-finite gradients at step {step}")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t_start
    launches = {w.__name__: w.launches for w in wrappers}
    moved = max((v.detach() - p0[k]).abs().max().item()
                for k, v in named_leaves(tr.params))
    n_timed = N_STEPS - TIME_FROM + 1
    peak = torch.cuda.max_memory_allocated()
    log(f"[slice] steps {TIME_FROM}-{N_STEPS}: {n_timed / dt:.3f} steps/s, "
        f"{rays / dt:.1f} rays/s; peak memory {peak / 2**30:.3f} GiB; "
        f"max |param change| {moved:.3e}; launches {launches}")
    if not moved > 0:
        raise AssertionError("params did not move")
    need = {"fused_adam": N_STEPS * n_leaves, "hash_block_fwd": N_STEPS,
            "hash_block_bwd": N_STEPS}
    for k, lo in need.items():
        if launches[k] < lo:
            raise AssertionError(f"{k} launched {launches[k]} times in the main "
                                 f"path, expected >= {lo}")
    return launches, tr


def phase_profile(tr, n_steps: int = 3) -> None:
    """torch.profiler over n_steps more steps: host and device time of each
    step span (f2nerf_torch/utils/spans.py), the device busy share, and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            tr.train_one()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()

    def dev(e, self_=False):
        name = ("self_" if self_ else "") + "device_time_total"
        return getattr(e, name, None) or getattr(e, name.replace("device", "cuda"), 0.0)

    def is_span(e):
        return e.key.startswith(("step.", "render."))

    # device busy = kernel time only (a span's device-side range is a
    # range, not work)
    busy_ms = sum(dev(e, True) for e in avgs if not is_span(e)) / 1e3
    log(f"[profile] {n_steps} steps: wall {wall_ms / n_steps:.2f} ms/step, device busy "
        f"{busy_ms / n_steps:.2f} ms/step ({100 * busy_ms / wall_ms:.1f}% of wall)")
    for e in sorted((e for e in avgs if is_span(e) and e.cpu_time_total > 0),
                    key=lambda e: -e.cpu_time_total):
        log(f"[profile] span {e.key:24s} host {e.cpu_time_total / 1e3 / n_steps:8.2f} ms/step"
            f"  device {dev(e) / 1e3 / n_steps:8.3f} ms/step  calls {e.count // n_steps}")
    kernels = sorted((e for e in avgs if dev(e, True) > 0 and not is_span(e)),
                     key=lambda e: -dev(e, True))
    for e in kernels[:12]:
        log(f"[profile] kernel {e.key[:70]:70s} {dev(e, True) / 1e3 / n_steps:8.3f} ms/step"
            f"  launches {e.count // n_steps}")


def phase_parity(tr) -> None:
    """One step from one saved state and one set of draws, card vs CPU,
    held to the tolerances of f2nerf_torch/utils/parity.py."""
    from f2nerf_torch.train.trainer import (Trainer, draw_step, flat_caps,
                                            make_core, max_s_for, render_statics)
    from f2nerf_torch.utils.parity import STEP_TOL, step_agrees, step_errors
    from f2nerf_torch.utils.tree import named_leaves

    tr.save_checkpoint()
    cfg = tr.cfg
    n_rays = 512                      # the first controller bucket's shapes
    max_s = max_s_for(n_rays, tr.pts_batch)
    cap1, cap2 = flat_caps(n_rays, max_s, tr.pts_batch, 512.0, 512.0, None,
                           max(16384, 2048))
    st = render_statics(cfg, n_rays, tr.dataset.near, train=True, max_s=max_s,
                        cap1=cap1, cap2=cap2, max_hits=64)
    gen = torch.Generator(device="cpu").manual_seed(7)
    draws_cpu = draw_step(gen, tr.dataset.device_arrays("cpu"), st, n_rays,
                          tr.dataset.height, tr.dataset.width, tr.tree)
    res = {}
    for dev in ("cuda", "cpu"):
        t = tr if dev == "cuda" else Trainer(
            cfg, tr.base_exp_dir, tr.dataset.data_path, device="cpu",
            tree_host=tr.tree_host)
        t.load_checkpoint()
        core = make_core(cfg, st, t.dataset.height, t.dataset.width)
        draws = {k: v.to(dev) for k, v in draws_cpu.items()}
        t0 = time.perf_counter()
        tree, aux, grads = core(t.params, t.opt_state, t.tree, t.consts, t.data,
                                t.runtime(), draws, n_rays)
        res[dev] = dict(
            loss=float(aux["loss"]), secs=time.perf_counter() - t0,
            n=float(aux["stats"]["n_meaningful"]), lr=float(t.runtime()["lr"]),
            params={k: v.detach().cpu() for k, v in named_leaves(t.params)},
            grads={k: v.detach().cpu() for k, v in named_leaves(grads)},
            occ={k: getattr(tree, k).cpu() for k in
                 ("weight_stats", "alpha_stats", "visit_cnt", "trans_idx")})
    a, b = res["cuda"], res["cpu"]
    err = step_errors(a["loss"], b["loss"], a["grads"], b["grads"], a["params"],
                      b["params"], a["occ"], b["occ"], b["lr"])
    p_abs = max((a["params"][k] - b["params"][k]).abs().max().item() for k in b["params"])
    log(f"[parity] loss cuda {a['loss']:.7f} cpu {b['loss']:.7f}; meaningful samples "
        f"cuda {a['n']:.0f} cpu {b['n']:.0f}; errors {err} (tolerances {STEP_TOL}); "
        f"max |param diff| {p_abs:.3e} at lr {b['lr']:.3e}; "
        f"step seconds cuda {a['secs']:.2f} cpu {b['secs']:.2f}")
    if not step_agrees(err):
        raise AssertionError("card and CPU steps disagree beyond the stated tolerances")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="device,build,kernels,slice,parity")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    full = set(phases) == {"device", "build", "kernels", "slice", "parity"}

    dev_info = phase_device()           # raises without CUDA, before any result
    if "build" in phases:
        phase_build()
    rows = phase_kernels() if "kernels" in phases else []
    launches = {}
    with tempfile.TemporaryDirectory(prefix="f2smoke_") as tmp:
        if "slice" in phases:
            launches, tr = phase_slice(tmp)
            if "profile" in phases:
                phase_profile(tr)
            if "parity" in phases:
                phase_parity(tr)
    for r in rows:
        r["launches"] = launches.get(r["name"], 0)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(f"card: {dev_info['smi']}")
    if not full:
        return 0
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": dev_info["name"],
                                             "count": dev_info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
