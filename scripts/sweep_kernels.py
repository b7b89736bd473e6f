"""Sweep the launch shapes and variants of K8-K11 and the offsets launch,
and show what their time is made of, on one CUDA card.

    python scripts/sweep_kernels.py [--kernels k8,k9,k10,k11,offsets] [--out results.json]

Each variant is a copy of a source in f2nerf_torch/csrc/ (traverse.cu,
march_parallel.cu or segment.cu) with a few text edits, built alone with
nvcc (the package's flags) into a library of its own under
f2nerf_torch/_build/sweep/, and timed on the same inputs as the unedited
kernel, in turns (CUDA events after ~1 ms of a busy stream, median).
Variants that keep the kernel's function are held to the unedited
kernel's outputs bit for bit (K10's, which add in another order, to the
plain version within 1e-5 of each ray's sum of |x|); diagnostic ones
(``diag``) change the arithmetic or drop work to show what that work
costs, and are only timed.

Inputs: K8 on the slice's tree (confs/wanjinyou.yaml at full width on the
ball scene, 945 nodes) with 2,048 uniform rays (hit cap 64) and with the
longest of them repeated 2,048 times (every warp on one path: the cost of
an iteration without divergence), each also with the tree read from
global memory; K9 on that tree with 2,048 uniform rays at hit cap 64 and
max_s 512, at 1, 2 and 4 rays a block; K11 at the slice's B buffer shape
(262,144 rows: 2,048 rays of 0-127 samples, the rest padding) and at
393,216 rows of 2,048 rays of 192; K10 (given the offsets launch's
offsets) and the offsets launch at 2,048 rays of 192 rows and at a
B-shaped buffer (2,048 rays of 0-139 rows), K10 at C = 1, 2, 6 and 16 and
at C = 16 read from the first 16 columns of a [n, 32] buffer (the layout
of the appearance gather's gradient). A one-element torch add is timed the
same way: the floor of a launch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from f2nerf_torch import kernels  # noqa: E402

SWEEP_DIR = os.path.join(REPO, "f2nerf_torch", "_build", "sweep")
PREFILL_CYCLES = 2_000_000
REPS = 20
ROUNDS = 3

K8_FILL = "for (int k = cj + lane; k < H; k += 32) {"
# staging by cp.async instead (every copy in flight, no registers, one wait)
K8_STAGE = """      int4 v[kStage];
#pragma unroll
      for (int k = 0; k < kStage; ++k)
        if (i0 + k * kThreads < total) v[k] = __ldg(rec_g + i0 + k * kThreads);
#pragma unroll
      for (int k = 0; k < kStage; ++k)
        if (i0 + k * kThreads < total) smem[i0 + k * kThreads] = v[k];
    }
    for (int i = threadIdx.x; i < n_nodes; i += kThreads) strans[i] = __ldg(trans_g + i);"""
K8_STAGE_ASYNC = """      for (int k = 0; k < kStage; ++k)
        if (i0 + k * kThreads < total)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
              (unsigned)__cvta_generic_to_shared(smem + i0 + k * kThreads)),
              "l"(rec_g + i0 + k * kThreads) : "memory");
    }
    for (int i = threadIdx.x; i < n_nodes; i += kThreads)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
          (unsigned)__cvta_generic_to_shared(strans + i)), "l"(trans_g + i) : "memory");
    asm volatile("cp.async.wait_all;" ::: "memory");"""
K8_VARIANTS = {
    "base": [],
    "threads32": [("constexpr int kThreads = 64;", "constexpr int kThreads = 32;")],
    "threads128": [("constexpr int kThreads = 64;", "constexpr int kThreads = 128;")],
    "diag_fast_div": [("__fdiv_rn(", "__fdividef(")],
    "diag_no_fill": [(K8_FILL, "for (int k = H; k < H; k += 32) {")],
    "diag_no_emit_store": [("if (emit) {", "if (emit && H < 0) {")],
    "stage1": [("constexpr int kStage = 16;", "constexpr int kStage = 1;")],
    "stage8": [("constexpr int kStage = 16;", "constexpr int kStage = 8;")],
    "stage_cp_async": [(K8_STAGE, K8_STAGE_ASYNC)],
}
K11_LOOKBACK = "for (long long b = (long long)tile - 1; b >= 0; b -= 32) {"
K11_VARIANTS = {
    "base": [],
    "tile4096": [("constexpr int kChunks = 8;", "constexpr int kChunks = 16;")],
    "tile1024": [("constexpr int kChunks = 8;", "constexpr int kChunks = 4;")],
    "warps4": [("constexpr int kWarps = 8;", "constexpr int kWarps = 4;")],
    "diag_no_lookback": [(K11_LOOKBACK, "for (long long b = -1; b >= 0; b -= 32) {")],
}
K10_VARIANTS = {
    "base": [],
    "vec2": [("constexpr int kUnrollVec = 4;", "constexpr int kUnrollVec = 2;")],
    "vec8": [("constexpr int kUnrollVec = 4;", "constexpr int kUnrollVec = 8;")],
    "tile4": [("constexpr int kTile = 8;", "constexpr int kTile = 4;")],
    # a launch that reads each ray's offsets and writes its zeros, no rows
    "diag_no_rows": [
        ("for (long long i = s + lane / Q; i < e;", "for (long long i = e; i < e;"),
        ("for (long long i = s + lane; i < e;", "for (long long i = e; i < e;")],
}
# the offsets launch's grid: every block the card holds at once (base), or
# one or two a multiprocessor (fewer blocks at the grid barrier, more rows
# a thread)
OFFSETS_GRID = "    resident[dev] = sms * per_sm;"
OFFSETS_VARIANTS = {
    "base": [],
    "one_a_sm": [(OFFSETS_GRID, "    resident[dev] = sms;")],
    "two_a_sm": [(OFFSETS_GRID, "    resident[dev] = 2 * sms;")],
}
K9_BOUNDS = "__global__ void __launch_bounds__(kMaxThreads, 4)"
K9_ROW_LOAD = ("      const float4 r0 = __ldg(m4 + 8 * kq + 2 * kk), "
               "r1 = __ldg(m4 + 8 * kq + 2 * kk + 1);")
K9_VARIANTS = {
    "base": [],
    # 79 registers, no spills, but fewer rays resident at once
    "regs128": [(K9_BOUNDS, "__global__ void __launch_bounds__(kMaxThreads, 2)")],
    # a group's eight w2xz float4s loaded up front (spills at 64 registers)
    "rows_per_group": [
        ("    float4 w[3];\n",
         "    float4 w[3], m[8];\n#pragma unroll\n"
         "    for (int j = 0; j < 8; ++j) m[j] = __ldg(m4 + 8 * kq + j);\n"),
        (K9_ROW_LOAD, "      const float4 r0 = m[2 * kk], r1 = m[2 * kk + 1];")],
}
K9_RAYS_PER_BLOCK = (1, 2, 4)    # csrc/march_parallel.cu: at most 256 threads a block


def log(*a):
    print(*a, flush=True)


def build(kind: str, variants: dict) -> dict:
    """One library a variant, all nvcc processes started together."""
    os.makedirs(SWEEP_DIR, exist_ok=True)
    src = open(os.path.join(kernels.CSRC, f"{kind}.cu")).read()
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{kind} {name}: {old!r} not in the source")
            text = text.replace(old, new)
        cu = os.path.join(SWEEP_DIR, f"{kind}_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = cu[:-3] + ".so"
        procs[name] = (so, subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", so, cu],
                                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True))
    libs = {}
    for name, (so, p) in procs.items():
        out, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {kind} {name}:\n{err}")
        regs = [ln.strip() for ln in err.splitlines() if "registers" in ln or "stack" in ln]
        log(f"[build] {kind} {name}: {regs}")
        libs[name] = ctypes.CDLL(so)
    return libs


def cuda_ms(fn) -> list:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(REPS):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(PREFILL_CYCLES)
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return out


def in_turns(fns: dict) -> dict:
    times = {k: [] for k in fns}
    order = list(fns)
    for r in range(ROUNDS):
        for k in (order if r % 2 == 0 else order[::-1]):
            times[k] += cuda_ms(fns[k])
    return {k: statistics.median(v) for k, v in times.items()}


def bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def slice_tree():
    from f2nerf_torch.train.trainer import Trainer
    from f2nerf_torch.utils.config import compose
    from f2nerf_torch.utils.synthetic import write_ball_dataset
    tmp = tempfile.mkdtemp(prefix="f2sweep_")
    cfg = compose(os.path.join(REPO, "confs"), "wanjinyou", ["+train.fused_adam=true"])
    tr = Trainer(cfg, os.path.join(tmp, "exp"), write_ball_dataset(os.path.join(tmp, "ball")),
                 seed=2022, device="cuda")
    return tr.tree, float(cfg["pts_sampler"]["near"])


def sweep_k8() -> dict:
    from f2nerf_torch.sampler import device as dv
    libs = build("traverse", K8_VARIANTS)
    vp, i = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.f2_traverse.argtypes = [vp] * 13 + [i, i, i, i, vp]
        lib.f2_traverse.restype = ctypes.c_int
    tree, near = slice_tree()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    R, H = 2048, 64
    o = torch.rand((R, 3), generator=gen, device=dev) * 2.0 - 1.0
    d = torch.randn((R, 3), generator=gen, device=dev)
    d = d / dv.norm3(d)[:, None]
    nr, fr = torch.full((R,), near, device=dev), torch.full((R,), 1e8, device=dev)
    dv.traverse(tree, o, d, nr, fr, H)
    longest = int(torch.argmax(dv.traverse.last_iters))
    cases = {"uniform": (o, d, dv.traverse_smem_nodes(tree)),
             "one_ray_x2048": (o[longest].expand(R, 3).contiguous(),
                               d[longest].expand(R, 3).contiguous(),
                               dv.traverse_smem_nodes(tree))}
    i32 = dict(dtype=torch.int32, device=dev)

    def run(lib, ro, rd, smem):
        outs = (torch.empty((R, H), **i32), torch.empty((R, H), device=dev),
                torch.empty((R, H), device=dev), torch.empty((R,), **i32),
                torch.empty((R,), dtype=torch.bool, device=dev), torch.empty((R,), **i32),
                torch.empty((), **i32))
        kernels.check(lib.f2_traverse(
            tree.node_rec.data_ptr(), tree.trans_idx.data_ptr(),
            *(x.data_ptr() for x in (ro, rd, nr, fr) + outs), smem, R, H, 4096,
            kernels.stream_ptr(dev)), "sweep traverse")
        return outs

    res = {}
    for case, (ro, rd, smem) in cases.items():
        want = run(libs["base"], ro, rd, smem)
        torch.cuda.synchronize()
        iters = want[5]
        equal = {}
        for name, lib in libs.items():
            got = run(lib, ro, rd, smem)
            torch.cuda.synchronize()
            equal[name] = all(torch.equal(bits(g), bits(w)) for g, w in zip(got, want))
            if not name.startswith("diag") and not equal[name]:
                raise AssertionError(f"K8 {name} differs from the base kernel ({case})")
        # each variant, and the unedited kernel reading the tree from global
        # memory (in L1 after its first touch at this size) instead
        fns = {name: (lambda lib=lib: run(lib, ro, rd, smem)) for name, lib in libs.items()}
        fns["base_global"] = lambda: run(libs["base"], ro, rd, 0)
        equal["base_global"] = all(torch.equal(bits(g), bits(w))
                                   for g, w in zip(run(libs["base"], ro, rd, 0), want))
        t = in_turns(fns)
        loop = int(iters.max())
        res[case] = dict(ms=t, equal=equal, loop_iters=loop,
                         mean_iters=float(iters.float().mean()), smem_nodes=smem)
        log(f"[K8] {case} (R {R}, loop {loop} iterations, mean "
            f"{float(iters.float().mean()):.1f}, shared-memory nodes {smem}): " +
            ", ".join(f"{k} {v:.4f} ms ({v * 1e6 / loop:.0f} ns an iteration; equal "
                      f"{equal[k]})" for k, v in t.items()))
    return res


def sweep_k11() -> dict:
    from f2nerf_torch.ops import segment as sg
    libs = build("segment", K11_VARIANTS)
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dev = torch.device("cuda")
    states = {}
    for name, lib in libs.items():
        lib.f2_segment_scan.argtypes = [vp] * 4 + [ll, i, i, vp]
        lib.f2_segment_scan.restype = ctypes.c_int
        states[name] = torch.zeros((1 << 16,), dtype=torch.uint8, device=dev)
    rng = np.random.RandomState(3)
    cases = {}
    rid = np.repeat(np.arange(2048), rng.randint(0, 128, 2048))
    cases["step_b_262144"] = np.concatenate([rid, np.full(262144 - rid.shape[0], 2048)])
    cases["uniform_393216"] = np.repeat(np.arange(2048), 192)

    def run(name, x, first):
        out = torch.empty_like(x)
        kernels.check(libs[name].f2_segment_scan(
            x.data_ptr(), first.data_ptr(), out.data_ptr(), states[name].data_ptr(),
            x.shape[0], 1, 0, kernels.stream_ptr(dev)), "sweep segment_scan")
        return out

    res = {}
    for case, r in cases.items():
        rid_d = torch.from_numpy(r.astype(np.int32)).to(dev)
        first = sg.first_flags_from_ray_id(rid_d, 2048)
        x = torch.rand(rid_d.shape, device=dev)
        want = sg.segment_cumsum_plain(x, first)
        err, again = {}, {}
        for name in libs:
            got = run(name, x, first)
            rep = run(name, x, first)
            torch.cuda.synchronize()
            err[name] = (got - want).abs().max().item()
            again[name] = torch.equal(bits(got), bits(rep))
            if not name.startswith("diag") and not (err[name] <= 1e-6 * (1 + want.abs().max().item())
                                                    and again[name]):
                raise AssertionError(f"K11 {name} is off ({case}): {err[name]}, {again[name]}")
        t = in_turns({name: (lambda name=name: run(name, x, first)) for name in libs})
        res[case] = dict(ms=t, max_abs_err=err, repeats=again, n=int(r.shape[0]))
        log(f"[K11] {case}: " + ", ".join(f"{k} {v:.4f} ms (err {err[k]:.1e})"
                                          for k, v in t.items()))
    return res


def step_like_ray_ids() -> dict:
    rng = np.random.RandomState(5)
    rid = np.repeat(np.arange(2048), rng.randint(0, 140, 2048))
    return {"step_b_262144": np.concatenate([rid, np.full(262144 - rid.shape[0], 2048)]),
            "uniform_393216": np.repeat(np.arange(2048), 192)}


def sweep_k10() -> dict:
    from f2nerf_torch.ops import segment as sg
    libs = build("segment", {f"k10_{k}": v for k, v in K10_VARIANTS.items()})
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for lib in libs.values():
        lib.f2_segment_reduce.argtypes = [vp, ll, ll, vp, vp, i, i, vp]
        lib.f2_segment_reduce.restype = ctypes.c_int
    dev = torch.device("cuda")

    def run(name, x, offsets, c):
        out = torch.empty((2048, c), device=dev)
        kernels.check(libs[name].f2_segment_reduce(
            x.data_ptr(), x.stride(0) if x.dim() == 2 else 1, x.shape[0], offsets.data_ptr(),
            out.data_ptr(), 2048, c, kernels.stream_ptr(dev)), "sweep segment_reduce")
        return out

    res = {}
    for case, r in step_like_ray_ids().items():
        rid_d = torch.from_numpy(r.astype(np.int32)).to(dev)
        offsets = sg.ray_offsets(rid_d, 2048)[0]
        # C = 16 also as the appearance gather's gradient is laid out: the
        # first 16 columns of a [n, 32] buffer
        for c, width in ((1, 1), (2, 2), (6, 6), (16, 16), (16, 32)):
            x = torch.rand((rid_d.shape[0], width), device=dev)[:, :c]
            want = run("k10_base", x, offsets, c)
            plain = sg.segment_sum_plain(x, rid_d, 2048)
            scale = sg.segment_sum_plain(x.abs(), rid_d, 2048)
            torch.cuda.synchronize()
            equal = {}
            for name in libs:
                got = run(name, x, offsets, c)
                torch.cuda.synchronize()
                equal[name] = torch.equal(bits(got), bits(want))
                # the unrolls and tiles change the order of the adds
                if not name.startswith("k10_diag") and \
                        not bool(((got - plain).abs() <= 1e-5 * scale).all()):
                    raise AssertionError(f"K10 {name} is off ({case}, C {c})")
            t = in_turns({name: (lambda name=name: run(name, x, offsets, c)) for name in libs})
            res[f"{case}_c{c}_ld{width}"] = dict(ms=t, equal_to_base=equal)
            log(f"[K10] {case}, C {c}, row stride {width}: " + ", ".join(
                f"{k[4:]} {v:.4f} ms (bits of base {equal[k]})" for k, v in t.items()))
    return res


def sweep_offsets() -> dict:
    from f2nerf_torch.ops import segment as sg
    libs = build("segment", {f"offsets_{k}": v for k, v in OFFSETS_VARIANTS.items()})
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for lib in libs.values():
        lib.f2_ray_offsets.argtypes = [vp] * 4 + [ll, i, vp]
        lib.f2_ray_offsets.restype = ctypes.c_int
    dev = torch.device("cuda")

    def run(name, rid):
        n = rid.shape[0]
        outs = (torch.empty((2049,), dtype=torch.int32, device=dev),
                torch.empty((2048,), device=dev), torch.empty((n,), dtype=torch.int32, device=dev))
        kernels.check(libs[name].f2_ray_offsets(
            rid.data_ptr(), *(o.data_ptr() for o in outs), n, 2048, kernels.stream_ptr(dev)),
            "sweep ray_offsets")
        return outs

    res = {}
    for case, r in step_like_ray_ids().items():
        rid_d = torch.from_numpy(r.astype(np.int32)).to(dev)
        want = sg.ray_offsets_plain(rid_d, 2048)
        for name in libs:
            got = run(name, rid_d)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"ray_offsets {name} differs from its plain version ({case})")
        t = in_turns({name: (lambda name=name: run(name, rid_d)) for name in libs})
        res[case] = t
        log(f"[offsets] {case}: " + ", ".join(f"{k[8:]} {v:.4f} ms" for k, v in t.items()))
    return res


def sweep_k9() -> dict:
    from f2nerf_torch.sampler import device as dv
    libs = build("march_parallel", K9_VARIANTS)
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for lib in libs.values():
        lib.f2_ray_march_parallel.argtypes = [vp] * 18 + [i, i, i, f, i, i, i, vp]
        lib.f2_ray_march_parallel.restype = ctypes.c_int
    tree, near = slice_tree()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    R, H, max_s = 2048, 64, 512
    o = torch.rand((R, 3), generator=gen, device=dev) * 2.0 - 1.0
    d = torch.randn((R, 3), generator=gen, device=dev)
    d = d / dv.norm3(d)[:, None]
    hits = dv.traverse(tree, o, d, torch.full((R,), near, device=dev),
                       torch.full((R,), 1e8, device=dev), H)[:4]
    jitter = torch.rand((R, max_s), generator=gen, device=dev) * (1 - 1e-4) + 1e-4
    fineness = torch.ones((), device=dev)
    args = (tree, o, d, *hits, jitter, fineness, 1.0 / 256, True, max_s)
    want = dv.ray_march_parallel_plain(*args)
    ray_threads = dv.ray_march_parallel_geometry(H)["ray_threads"]

    def run(lib, k):
        outs = (torch.empty((R, max_s), device=dev), torch.empty((R, max_s), device=dev),
                torch.empty((R, max_s), dtype=torch.int32, device=dev),
                torch.empty((R,), dtype=torch.int32, device=dev), torch.empty((R,), device=dev))
        ins = (*hits, o, d, jitter, fineness, tree.trans_idx, tree.w2xz, tree.weight,
               tree.t_center, tree.t_dis)
        kernels.check(lib.f2_ray_march_parallel(
            *(x.data_ptr() for x in ins + outs), R, H, max_s, 1.0 / 256, 1, ray_threads, k,
            kernels.stream_ptr(dev)), "sweep ray_march_parallel")
        return outs

    fns, equal = {}, {}
    for name, lib in libs.items():
        for k in K9_RAYS_PER_BLOCK:
            got = run(lib, k)
            torch.cuda.synchronize()
            equal[f"{name}_k{k}"] = all(torch.equal(bits(g), bits(w)) for g, w in zip(got, want))
            if not equal[f"{name}_k{k}"]:
                raise AssertionError(f"K9 {name}, {k} rays a block, differs from the plain version")
            fns[f"{name}_k{k}"] = lambda lib=lib, k=k: run(lib, k)
    t = in_turns(fns)
    log(f"[K9] uniform rays (R {R}, H {H}, {int(hits[3].sum())} hits, "
        f"{int(want[3].sum())} samples; {ray_threads} threads a ray, _k rays a block): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items()))
    return dict(ms=t, equal=equal)


SWEEPS = {"k8": sweep_k8, "k9": sweep_k9, "k10": sweep_k10, "k11": sweep_k11,
          "offsets": sweep_offsets}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default=",".join(SWEEPS),
                    help="comma-separated sweeps to run, of " + ", ".join(SWEEPS))
    ap.add_argument("--out", default=os.path.join(SWEEP_DIR, "sweep_kernels.json"))
    args = ap.parse_args()
    chosen = args.kernels.split(",")
    unknown = [k for k in chosen if k not in SWEEPS]
    if unknown:
        raise SystemExit(f"unknown sweeps {unknown}; choose from {list(SWEEPS)}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"card: {smi}")
    one = torch.zeros(1, device="cuda")
    floor = statistics.median(cuda_ms(lambda: one.add_(0)))
    log(f"[floor] a one-element add: {floor:.4f} ms")
    t0 = time.perf_counter()
    out = dict(card=smi, floor_ms=floor, **{k: SWEEPS[k]() for k in chosen})
    log(f"[time] {time.perf_counter() - t0:.1f} s")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
