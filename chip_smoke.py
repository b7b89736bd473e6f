"""Drive the port's main path (f2nerf_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase; needs one CUDA card
    python3 chip_smoke.py --phases build,kernels   # a subset (no final line)
    python3 chip_smoke.py --phases device,build,kernels,slice,profile \
        --baseline DIR    # an earlier tree's atomic K6 (a checkout in DIR),
                          # and its slice step's launches and steps/s,
                          # beside this tree's, in turns

Phases:
  1. device  — refuse to run without CUDA; print the card, its power limit
               and its max SM clock (K7's chain bound reads it).
  2. build   — compile the hand-written kernels from f2nerf_torch/csrc/.
  3. kernels — each kernel against its plain PyTorch version on the card:
               max error against the stated tolerance, the median time of
               both (CUDA events), the bound (bytes over 3.35 TB/s) and the
               library call where one computes the same function
               (torch._fused_adam_ for K1, in turns; index_select for K4).
               K2/K3 at a uniform shape (n 393,216, a random volume per
               sample; K3 bit for bit its plain version and a second run,
               also at 2^18 samples in one row a level, 2^20 samples and
               log2_table_size 20; the library call for K3: index_add_ of
               the dense rows, deterministic), K5 and K6 at the same uniform shape
               (K6 bit for bit its plain version and a second run, also at
               2^18 samples in one cell a level, 2^20 samples and
               log2_table_size 20; its library call index_add_ of the
               records, deterministic; with --baseline ROOT, ROOT's atomic
               K6 with its zero-fill in turns, uniform, skewed, at
               log2_table_size 20 and at variants (a)'s step's inputs),
               K4 at micro_gather's shape; after the slice, each
               again at the slice's own inputs (kernels_at_slice_inputs:
               K2 on A at cap1, K3 on B at cap2 plus the edge samples with
               that step's gradient, K4 on the step's cached encodings and
               grad-pass indices, all captured from one more step; K4 also
               at an earlier stand-in for them; K8, the traversal, at the
               step's own rays, 2,048 uniform rays, distant origins,
               grazing rays on a culled copy of the tree, and uniform rays
               on the tree split to just under and just over the node
               count K8 stages in shared memory, all equal to
               traverse_plain with the floats bit for bit; K9, the
               parallel marcher, at the step's own hits, with
               scale_by_dis flipped, eval's all-ones jitter, a degenerate
               warp and the step's rays at hit caps 16 and 40, bit for
               bit its plain version; K10 and K11, the segment ops, and the offsets
               launch that K10 reads (computed, and with the offsets
               given, as the single-pass step launches it), at 2,048
               uniform rays of 192 samples (K10 at C = 1, 2, 6 and 16) and
               at every call of one step, forward and backward, each
               launch repeated bit for bit, K10 beside
               torch.segment_reduce, K11 and the offsets launch one device
               launch a call (torch.profiler);
               K12 (the A compaction with its warp and A's ray offsets,
               held to the offsets launch's, and the edge samples' warp),
               K13 (the keep-set compaction A -> B with B's ray segments:
               offsets, counts, local indices, first flags) and K14 (the occupancy
               votes, with the offsets given and computed, and their fold)
               at the step's own inputs and at their edge cases (a
               uniform slice shape, overflow past the capacity, nothing
               kept, K13 also with no padding row in A, rays with no row,
               one ray and B exactly full, the degenerate warp's inf and
               NaN, NaN, +-inf and -0.0 weights), every output bit for bit
               its plain version, each launch repeated bit for bit, the
               votes beside one scatter_reduce amax); K15 (the rays) at
               the step's own draws and tables and over one whole image
               in its camera form, bit for bit its plain route and a
               repeated launch.
               K7's and K8's
               bounds also have a chain term (march_case, traverse_case):
               the longest ray's dependent operations at the card's max
               SM clock.
  4. slice   — the ball scene, confs/wanjinyou.yaml at full width with
               +train.fused_adam=true, 20 Trainer.train_one steps on the card;
               losses finite, grads finite, params moved, every kernel
               launched by the main path (launch counters reset just before),
               the table-gradient scatter K3, the traversal K8, the
               marcher K9, K12's two entry points, K13, K14's two and
               K15 exactly once a step, K10 five times and K11 three times a
               step, the offsets launch never (K13 writes B's segments);
               then one pipelined
               train_many chunk under torch.cuda.set_sync_debug_mode:
               the synchronizing calls a step by span, none allowed in
               the render's spans or the occupancy fold (sync_counts);
               then one step run twice from one state with one set of
               draws, torch's deterministic algorithms off: every gradient
               leaf, parameter, Adam state leaf and occupancy counter bit
               for bit (step_twice).
  5. parity  — one step from one saved state with one set of draws on the
               card (kernels) and on the CPU (plain versions), compared.
  6. maintain — octree maintenance on the card: (a) the slice's config with
               compact_freq 10 and milestones [20, 40] for 50 steps (five
               maintenance events, each printed with its host seconds);
               (b) one step card vs CPU on the subdivided tree, as parity;
               (c) milestones [0, 0, 0]: three brute-force subdivisions
               after the first step (~224k nodes), then 5 timed steps, and
               K8/K9 against their plain versions at one more step's
               inputs on that tree. K3, K8 and K9 held to one launch a
               step throughout.
  7. runner  — the port's CLI (f2nerf_torch.run.main) at full width on the
               ball scene: mode=train for 40 iterations (report, stats, save,
               vis cadences, then the test render; the Runner steps through
               Trainer.train_auto, its (iteration, chunk) calls printed),
               then mode=render_path from the checkpoint; the artifact set,
               launch counts of both runs, and Trainer.render_image timed
               over all 24 cameras.
  8. eval_parity — one test camera rendered from the saved checkpoint on the
               card (kernels) and on the CPU (plain versions), compared.
  9. bench   — the benchmark entry (f2nerf_torch/bench.py) at full width on
               the ball scene (phase_bench): run_bench's JSON line (settle
               60, 40 timed steps); on a second settled, frozen trainer,
               timed turns of synced single steps and pipelined chunks
               (synced, pipelined, pipelined, synced; rays/s each), K1-K4
               launches over the first pipelined turn; then train_many(3)
               against three train_one calls from one state and one set of
               draws, within STEP_TOL and bit for bit, with torch's
               deterministic algorithms on and off (K3, K10 and K11 sum in
               a fixed order).
 10. variants — the configurations beside the default slice
               (phase_variants): (a) the reference-semantics config
               (field.type=Hash3DAnchored +pts_sampler.march_mode=lockstep)
               at full width, 20 steps timed as the slice is, K5 twice and
               K6/K7 once a step (K2/K3/K4 never); K5/K6/K7 at that
               step's own inputs (spied; K5's two launches, A and B +
               edges, each at its own) and K7 at a uniform shape
               against their plain versions; one step run twice from one
               state bit for bit (step_twice) and chunk_parity, both held
               (K6 sums in a fixed order); one step card vs CPU;
               render_image over the 24 cameras and one image card vs
               CPU; (b) HashBlock +train.single_pass=true, 10 single-pass
               steps (K3 once a step, K4 and K13 never, the offsets
               launch once a step with K12's offsets given), one step
               card vs CPU;
               (c) data_at_gpu=false and ray_sample_mode=single_image, 3
               steps each, then Trainer.reset and a step; (d) one
               two-pass eval render card vs CPU for each field.
               K5/K6 are also timed at the kernels phase's uniform shape.
 11. configs — confs/llff.yaml, free.yaml, nerf-360.yaml and
               wanjinyou_big.yaml on the ball scene at their own full
               widths with +train.fused_adam=true (phase_configs): 10
               steps each (steps/s, rays/s, peak memory, cap1/cap2, hit
               cap, K1-K4's launches; K3, K4 and K15 exactly once a step), one
               step run twice from one state bit for bit (step_twice);
               llff also one step card vs CPU.
 12. data_parallel — the data-parallel path at full width on the ball
               scene (phase_data_parallel): (a) world size 1 on NCCL, one
               step of a Trainer under the process group against a plain
               Trainer from one state with one set of draws (torch's
               deterministic algorithms, STEP_TOL), then 10 steps with the
               collectives timed; (b) two gloo ranks sharing cuda:0 (spawned
               processes), 20 iterations each through train_auto: params,
               Adam state, tree and controller state bitwise equal across
               the ranks (all-reduced checksums), K1-K4 launched on each
               rank, losses finite; steps/s, rays/s and the collectives' ms
               a step of each rank (two ranks on one card: not a scaling
               figure). A failed rank fails the phase.
  march      — not run by default: K7 alone at variants (a)'s step inputs
               and uniform shape, for kernel sweeps (--phases
               device,build,march).
  profile    — not run by default: torch.profiler over 3 more slice steps,
               per-span host/device time, the device busy share (device
               events only, beside the earlier count that took a kernel
               launched through an aten op twice), the top kernels and
               a step's launches (device activities, outermost aten ops)
               (--phases device,build,kernels,slice,profile); with the
               variants phase, also over 3 more steps of its config (a);
               with --baseline ROOT, the launches phase of ROOT's package
               and of this tree's, one process each, in turns (ROOT,
               this, this, ROOT: launch_turns; this tree's step held to
               STEP_DEVICE_LAUNCHES and STEP_ATEN_OPS).
  launches   — not run by default: LAUNCH_TURN_STEPS synced slice steps
               timed, then the profile phase's counts, as one JSON line
               (--phases device,build,launches [--package-root ROOT]).
  atomics    — not run by default: one slice step twice from one state,
               torch's deterministic algorithms off, every aten op's
               inputs and outputs fingerprinted: the ops whose output
               depends on the order of their float sums, with where they
               ran, and each gradient leaf bit for bit (phase_atomics).
  ref_atomics — not run by default: the atomics phase on variants (a)'s
               trainer after its 20 steps (phase_ref_atomics; --phases
               device,build,ref_atomics [--package-root ROOT]).
  Without the slice phase, profile, atomics and launches build the slice's
  trainer and take its 20 steps uncounted (--phases
  device,build,profile,atomics), so the same script can time a parent
  tree's package (--package-root).

The last lines are the kernels JSON, the card line, and the result JSON.
Any failed phase raises, and the script exits non-zero without a result.
"""

from __future__ import annotations

import argparse
import copy
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

REPO = os.path.dirname(os.path.abspath(__file__))
DEV = "cuda"           # the card; the variants phase reads it
N_STEPS = 20
TIME_FROM = 4          # steps 4..20 are timed (the first ones warm up)

# K1/K2 tolerances: the kernel and its plain version do the same f32
# operations in the same order (K2 rounds its index math per operation),
# so they agree to a few ulps. K3 and K6 sum in their plain versions'
# order and are held to them bit for bit. The earlier K6 that --baseline
# times sums with atomics in no fixed order: the error grows with the
# number of terms per table entry, so it is held relative to the largest
# gradient magnitude. K4 copies rows, so it is held to
# index_select bit for bit.
TOL_ADAM = 1e-6
TOL_ENCODE = 1e-6
TOL_SCATTER_REL = 1e-5
# K7 rounds every operation as its plain version does (no FMA): sample
# counts and nodes must be equal; positions and steps are held to 1e-6
# relative
TOL_MARCH_REL = 1e-6
RUNNER_ITERS = 40      # the runner phase's mode=train iterations
PHASES = ("device", "build", "kernels", "slice", "parity", "maintain", "runner",
          "eval_parity", "bench", "variants", "configs", "data_parallel")
# the runner phase's train_auto calls, (iteration, chunk): chunks of
# train.step_chunk = 10, each ending on a report/vis/stats/save cadence
RUNNER_CHUNKS = [(0, 10), (10, 10), (20, 10), (30, 10)]
# the bench phase: settle iterations (chunks of 10 from iteration 0, so
# every timed turn starts on a chunk boundary; the EMAs, fetched up to 3
# chunks late, have seen ~30 steps when the bucket freezes), the bench's
# own timed steps, the steps of each timed turn, and the chunk held
# against steps
BENCH_SETTLE = 60
BENCH_STEPS = 40
BENCH_TURN_STEPS = 20
BENCH_CHUNK = 3
# the variants phase: the reference-semantics config (a), single-pass
# training (b), the host loader / single-image sampling / reset (c)
REF_OVERRIDES = ["field.type=Hash3DAnchored", "+pts_sampler.march_mode=lockstep"]
VAR_STEPS = 20
SINGLE_PASS_STEPS = 10
HOST_STEPS = 3
# the configs phase: the repo's other configurations on the ball scene at
# their own full widths, CONFIG_STEPS steps each (steps TIME_FROM on timed)
CONFIGS = ("llff", "free", "nerf-360", "wanjinyou_big")
CONFIG_STEPS = 10
# the data_parallel phase: steps timed at world size 1 on NCCL, and the
# train_auto iterations of each of the two gloo ranks (two chunks of 10;
# the second is timed)
DP_STEPS = 10
DP_ITERS = 20
# K7's operations bound: f32 operations of one EMIT evaluation (the warp
# Jacobian: 12 projections x 33, the step and the sample ~20), over the
# H100 SXM's 67 TFLOP/s f32 peak outside the tensor cores
MARCH_FLOPS_PER_EMIT = 416
F32_FLOPS = 67e12
# K7's chain bound: a ray's iterations depend on one another (t), so the
# kernel takes at least the longest ray's chain of dependent operations,
# each >= CYCLES_PER_OP cycles (an f32 add or multiply's latency) at the
# card's max SM clock. Dependent f32 operations on one iteration's
# critical path, every independent one taken as running in parallel and
# each __fdiv_rn / __fsqrt_rn counted as one (so this stays a lower bound):
#   EMIT: x = o + d t (mul, add: 2), a projection's a (3 adds after the
#   parallel muls: 4), b * b (1), a / (b b) (1), dvd (mul by r1d, sub: 2),
#   the product with w (1), the 12 ordered adds (12), s (mul, 2 adds: 3),
#   the sqrt (1), + 1e-6 (1), e (the division: 1), the radius product (1),
#   t + e (1), the test (1): 32;
#   ADVANCE: near - t (1), / step (1), the clamp (1), ceil (1), * step
#   (1), t + step (1), the test (1): 7.
MARCH_CHAIN_EMIT = 32
MARCH_CHAIN_ADVANCE = 7
CYCLES_PER_OP = 4
# K8's chain bound, as K7's: a ray's iterations depend on one another (t,
# u), so the kernel takes at least the longest ray's iterations (counted by
# traverse_plain) times the dependent f32 operations of the shortest kind
# of iteration, CYCLES_PER_OP cycles each at the max SM clock. The loads on
# the path (the node's row, its child, the child's center, the rope) are
# not counted, so this stays a lower bound. Per kind, every independent
# operation taken as running in parallel, a division or a comparison
# counted as one:
#   descent (p inside the child): p >= center (1), then, once the child's
#   row is loaded, |p - child center| (1), its max over the axes (2), the
#   test against half the child's side (1): 5;
#   leaf: max(far, t) (1), eps's ulp term and its two maxima (3), t + eps
#   (1), p = o + d (t + eps) (2), the next containment test (4): 11 (the
#   node's slab, 8 more, runs beside them once its row is loaded);
#   skip: the octant's and the child's slabs, then the skip point: > 11.
TRAV_CHAIN = 5
# a tree row K8 reads: its node record (center, side, children, ropes,
# is_leaf: 80 B) and its trans_idx
TRAV_NODE_BYTES = 80 + 4
# K8's uniform case: rays from U[-1, 1]^3, uniform directions, hit cap 64
TRAV_UNIFORM_RAYS = 2048
CARD = {}              # what phase_device reads of the card (max SM clock)
# --baseline ROOT with the profile phase: a slice step's launches and the
# slice's steps/s of ROOT's package and of this tree's, one process each, in
# turns (launch_turns): ROOT, this, this, ROOT; each process times
# LAUNCH_TURN_STEPS synced steps after the slice's steps
LAUNCH_TURN_STEPS = 40
# a profiled slice step of this tree launches at most STEP_DEVICE_LAUNCHES
# device activities and dispatches at most STEP_ATEN_OPS outermost aten ops
# (before K13 wrote B's segments: 1,482 and 1,615; then 1,474-1,475 and
# 1,609; since K3 is 9 launches and a memset where it was a zero-fill and
# one launch, PERF.md §5): launch_turns holds them. The count leaves out
# the spans' device-side annotations, which it took in until 13 a step
# (1,474-1,475 then; 1,460 without them): the bound was 1,483 with them.
# Since K15 makes the rays in one launch: 537 and 655 (from 1,460 and 1,610)
STEP_DEVICE_LAUNCHES = 547
# the ranges of f2nerf_torch/utils/spans.py, by family
SPAN_PREFIXES = ("step.", "render.", "eval.", "setup.", "build.", "backward.", "image.")
STEP_ATEN_OPS = 655
OCC_FIELDS = ("weight_stats", "alpha_stats", "visit_cnt", "trans_idx")
KERNEL_ORDER = ("fused_adam", "hash_block_fwd", "hash_block_bwd", "row_gather",
                "hash_encode_fwd", "hash_encode_bwd", "ray_march", "traverse",
                "ray_march_parallel", "ray_offsets", "segment_reduce", "segment_scan",
                "compact_a_warp", "sample_edges", "compact_keep", "compute_occupancy_adders",
                "apply_occupancy_adders", "rays_kernel")
# K10/K11 tolerances against their plain versions: K10 sums f32 in another
# order than index_add, so it is held to 1e-5 of each ray's sum of |x|; K11
# and the plain version both sum in f64 and round once to f32 (an f32 ulp
# apart at most): rtol 1e-6, atol 1e-6. A launch repeated gives the same
# bits (both).
TOL_SEG_SUM_REL = 1e-5
TOL_SCAN = 1e-6
# K10/K11's uniform case: 2,048 rays of 192 samples (the slice's cap1)
SEG_RAYS, SEG_PER_RAY = 2048, 192
NO_LIBRARY_SCAN = "none: no single PyTorch call computes a segmented scan"
# the spans that must not synchronize the host on the card (sync_counts):
# every span of the render and the occupancy fold
NO_SYNC_SPANS = ("render.traverse", "render.march", "render.compact_a_warp",
                 "render.prefilter", "render.compact_b", "render.field_shader",
                 "render.composite", "step.occupancy_fold")
# the maintain phase: (a) a compressed maintenance schedule, (c) real scale
MAINT_STEPS = 50
MAINT_OVERRIDES = ["pts_sampler.compact_freq=10", "pts_sampler.sub_div_milestones=[20,40]"]
MAINT_EVENTS = [10, 20, 30, 40, 50]
MAINT_MILESTONES = (20, 40)
REAL_SCALE_STEPS = 5
REAL_SCALE_MIN_NODES = 150_000
# a kernel's bound: the bytes it must move (each input read once, each
# output written once) over the H100 SXM's 3.35 TB/s HBM3; none of these
# kernels is near its operations bound
HBM_BYTES_PER_S = 3.35e12
PREFILL_CYCLES = 2_000_000     # ~1 ms of the SM clock (cuda_time)
NO_LIBRARY = "none: no single PyTorch call computes the hashed trilinear " \
             "encode or its scatter"
NO_LIBRARY_MARCH = "none: no PyTorch call marches rays through their hit lists"
NO_LIBRARY_TRAVERSE = "none: no PyTorch call traverses an octree"
NO_LIBRARY_MARCH_PARALLEL = "none: no PyTorch call marches a jittered grid"
NO_LIBRARY_WARP = "none: no PyTorch call warps points through per-leaf projections"
NO_LIBRARY_KEEP = ("none: no single PyTorch call compacts kept rows into a padded buffer "
                   "(torch.nonzero_static, the indices alone, timed beside)")
NO_LIBRARY_FOLD = "none: no single PyTorch call folds the votes into the counters"
NO_LIBRARY_RAYS = "none: no PyTorch call undistorts pixels into rays"
# K15's bytes: a camera's rows (pose 48, intrinsics 36, distortion 16) and
# in the training form its train id (4) and bounds (8); a training ray's
# 3 image bytes and 48 bytes out (rays_o, rays_d, gt, bounds, img_idx)
RAYS_CAM_BYTES, RAYS_TRAIN_CAM_BYTES = 100, 112
RAYS_RAY_BYTES = 3 + 48
LIBRARY_VOTES = "torch.Tensor.scatter_reduce amax (one of the votes' three node scatters)"
LIBRARY_K3 = ("torch.Tensor.index_add_ of the active pairs' prebuilt dense 128-lane rows "
              "into the [16 nb, 128] table, deterministic algorithms on: the scatter alone")
LIBRARY_K6 = ("torch.Tensor.index_add_ of the active (entry, value) records into the "
              "[pool, 2] gradient, deterministic algorithms on: the scatter alone")


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def cuda_time(fn, reps: int = 10, prefill: bool = True) -> float:
    """Median milliseconds of fn() over reps, CUDA events, after a warm-up.
    With ``prefill`` the stream is first held busy for ~1 ms
    (torch.cuda._sleep), so the host has enqueued fn before the device
    reaches the start event and the time is the device's alone; without
    it, the wrapper's host time (checks, allocation, the launch call)
    counts wherever it exceeds the device's work (PERF.md's earlier
    kernel times were taken so).
    L2 is warm: each launch finds what the one before it left there, as
    the step's caller finds the inputs it has just written."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if prefill:
            torch.cuda._sleep(PREFILL_CYCLES)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def cuda_time_turns(fns: dict, rounds: int = 3) -> dict:
    """Median ms of each function, timed in turns (a, b, b, a, a, b, ...)
    so that the card's state drifts alike for all of them."""
    times = {k: [] for k in fns}
    order = list(fns)
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            times[k].append(cuda_time(fns[k]))
    return {k: statistics.median(v) for k, v in times.items()}


def touched_rows(prim, bias, pts, vol, l2t: int) -> int:
    """Distinct (level, row) pairs these samples touch: K2 must read that
    many 512-B rows of the table, and K3 adds into that many."""
    from f2nerf_torch.fields import hash_block as hb
    from f2nerf_torch.fields.hash_encoding import level_scales
    nb, sc, vol = hb.n_blocks(l2t), level_scales(), vol.long()
    keys = [l * nb + hb._locate(pts, prim[l, vol], bias[l, vol], float(sc[l]), nb)[0]
            for l in range(len(sc))]
    return int(torch.unique(torch.cat(keys)).numel())


def wrappers():
    """Every kernel wrapper, each with its ``launches`` count."""
    from f2nerf_torch.fields import hash_block as hb
    from f2nerf_torch.fields import hash_encoding as he
    from f2nerf_torch.ops import fused_adam as fa
    from f2nerf_torch.ops import gather as ga
    from f2nerf_torch.ops import rays as ry
    from f2nerf_torch.ops import segment as sg
    from f2nerf_torch.sampler import device as dv
    from f2nerf_torch.render import renderer as rd
    return (fa.fused_adam, hb.hash_block_fwd, hb.hash_block_bwd, ga.row_gather,
            he.hash_encode_fwd, he.hash_encode_bwd, dv.ray_march, dv.traverse,
            dv.ray_march_parallel, sg.ray_offsets, sg.segment_reduce, sg.segment_scan,
            rd.compact_a_warp, dv.sample_edges, rd.compact_keep, dv.compute_occupancy_adders,
            dv.apply_occupancy_adders, ry.rays_kernel)


def seg_need(k: int, single_pass: bool = False) -> dict:
    """K10 and K11 at least k times each (every render composites); the
    offsets launch too where the renders are single-pass (a two-pass
    render's B comes with its segments from K13)."""
    need = {"segment_reduce": k, "segment_scan": k}
    if single_pass:
        need["ray_offsets"] = k
    return need


def warp_need(k: int, train: bool = True, two_pass: bool = True) -> dict:
    """K12's A side at least k times (every render), K13 where the render
    has a prefilter (two passes), K12's edge samples, K14's votes and
    fold and K15 (the step's rays) where it trains."""
    need = {"compact_a_warp": k}
    if two_pass:
        need["compact_keep"] = k
    if train:
        need.update(sample_edges=k, compute_occupancy_adders=k, apply_occupancy_adders=k,
                    rays_kernel=k)
    return need


def reset_counts() -> None:
    for w in wrappers():
        w.launches = 0


def read_counts() -> dict:
    return {w.__name__: w.launches for w in wrappers()}


def check_counts(where: str, counts: dict, need: dict, exact: dict = None) -> None:
    for k, lo in need.items():
        if counts[k] < lo:
            raise AssertionError(f"{k} launched {counts[k]} times in {where}, "
                                 f"expected >= {lo}")
    for k, want in (exact or {}).items():
        if counts[k] != want:
            raise AssertionError(f"{k} launched {counts[k]} times in {where}, "
                                 f"expected exactly {want}")


def gather_check(table, idx, label: str) -> dict:
    """K4 against index_select on one shape: bit for bit, then the median
    time of both and the bytes each moves per second (rows read and
    written, plus the indices)."""
    from f2nerf_torch.ops import gather as ga
    got = ga.row_gather(table, idx)
    want = ga.row_gather_plain(table, idx)
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    err = (got - want).abs().max().item()
    del got, want
    ms = cuda_time(lambda: ga.row_gather(table, idx))
    # the same launches with the host's enqueue time counted (the earlier
    # timing): at tens of microseconds a kernel is shorter than its wrapper
    enqueued_ms = cuda_time(lambda: ga.row_gather(table, idx), prefill=False)
    plain_ms = cuda_time(lambda: ga.row_gather_plain(table, idx))
    n, w = idx.shape[0], table.shape[1]
    # yardstick: a contiguous device-to-device copy of the output's bytes
    src, dst = torch.empty((n, w), device=table.device), torch.empty((n, w), device=table.device)
    copy_ms = cuda_time(lambda: dst.copy_(src))
    del src, dst
    gbytes = (2 * n * w * 4 + n * idx.element_size()) / 1e9
    # the bound reads each distinct row once
    rows = torch.unique(idx).numel()
    bound = bound_ms(n * w * 4 + rows * w * 4 + n * idx.element_size())
    log(f"[kernels] K4 row_gather {label}: table {tuple(table.shape)} f32, n={n} "
        f"{str(idx.dtype)[6:]}, {rows} distinct rows: max_abs_err {err:.3e} "
        f"(bit for bit: {same}); kernel {ms:.4f} ms ({gbytes / ms * 1e3:.1f} GB/s), "
        f"index_select {plain_ms:.4f} ms ({gbytes / plain_ms * 1e3:.1f} GB/s); "
        f"bound {bound:.4f} ms ({100 * bound / ms:.1f}% of it); with the host's "
        f"enqueue counted {enqueued_ms:.4f} ms; a contiguous copy "
        f"of the output's {n * w * 4 / 1e6:.1f} MB {copy_ms:.4f} ms")
    if not same:
        raise AssertionError(f"row_gather disagrees with index_select ({label})")
    # the plain version is the library call index_select
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=plain_ms,
                bound_ms=bound, copy_ms=copy_ms, enqueued_ms=enqueued_ms, rows=rows, n=n)


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
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    CARD["max_sm_hz"] = float(clock) * 1e6
    log(f"[device] {name}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"nvidia-smi: {smi}; max SM clock {clock} MHz")
    return dict(name=name, smi=smi, count=torch.cuda.device_count())


def phase_build() -> None:
    from f2nerf_torch import kernels
    t0 = time.perf_counter()
    kernels.library()
    info = kernels.build_info()
    log(f"[build] {len(kernels.sources())} sources -> {kernels.library_path().name} "
        f"in {time.perf_counter() - t0:.2f} s (nvcc {info['seconds']} s)")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "Compiling entry" in line or "stack frame" in line:
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


def encode_case(args: tuple, label: str) -> dict:
    """K2 against its plain version on one input (feat, prim, bias, pts,
    vol, log2_table_size): the largest difference (0 when bit for bit),
    the median time of both, and the bound: points and volumes read, the
    touched rows read once, the encodings written."""
    from f2nerf_torch.fields import hash_block as hb
    _, prim, bias, pts, vol, l2t = args
    out_k, out_p = hb.hash_block_fwd(*args), hb.hash_block_fwd_plain(*args)
    torch.cuda.synchronize()
    err = (out_k - out_p).abs().max().item()
    same = torch.equal(out_k, out_p)
    del out_k, out_p
    ms = cuda_time(lambda: hb.hash_block_fwd(*args))
    plain_ms = cuda_time(lambda: hb.hash_block_fwd_plain(*args))
    n, rows = pts.shape[0], touched_rows(prim, bias, pts, vol, l2t)
    bound = bound_ms(n * (12 + 4) + rows * 512 + n * 128)
    log(f"[kernels] K2 hash_block_fwd {label}: n={n}, {rows} rows touched: "
        f"max_abs_err {err:.3e} (tol {TOL_ENCODE:g}; bit for bit: {same}); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
        f"({100 * bound / ms:.1f}% of it)")
    if not (np.isfinite(err) and err <= TOL_ENCODE):
        raise AssertionError(f"hash_block_fwd disagrees with its plain version "
                             f"({label}): {err}")
    return dict(max_abs_err=err, bit_for_bit=same, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, n=n, rows=rows)


def k3_rows_histogram(calls: list) -> dict:
    """K3's skew at these calls: active (sample, level) pairs a row, by
    level (rows touched, median, p99, max), from the plain version's list
    (hash_block.k3_entries)."""
    from f2nerf_torch.fields import hash_block as hb
    out = {}
    for a in calls:
        g, prim, bias, pts, vol, l2t, _ = a
        nb = hb.n_blocks(l2t)
        key = hb.k3_entries(torch.cat(hb._segments(g)), prim, bias,
                            torch.cat(hb._segments(pts)),
                            torch.cat(hb._segments(vol)).long(), nb)[0] >> 32
        per = torch.bincount(key, minlength=16 * nb).reshape(16, nb)
        for l in range(16):
            c = per[l][per[l] > 0].float()
            q = torch.quantile(c, torch.tensor([0.5, 0.99], device=c.device)).tolist() \
                if c.numel() else [0.0, 0.0]
            o = out.setdefault(l, dict(pairs=0, rows=0, median=0.0, p99=0.0, max=0))
            o.update(pairs=o["pairs"] + int(c.sum()), rows=o["rows"] + int(c.numel()),
                     median=q[0], p99=q[1], max=max(o["max"], int(c.max()) if c.numel() else 0))
    return out


def k3_library_ms(calls: list) -> float:
    """The library yardstick for K3: one index_add_ of the active pairs'
    prebuilt dense 128-lane rows (the plain version's values) into the
    [16 nb, 128] view of a zeroed table, under
    torch.use_deterministic_algorithms(True): the scatter alone (building
    the rows and zeroing the table are not timed)."""
    from f2nerf_torch.fields import hash_block as hb
    (g, prim, bias, pts, vol, l2t, shape), = calls
    key, lane, val = hb.k3_entries(torch.cat(hb._segments(g)), prim, bias,
                                   torch.cat(hb._segments(pts)),
                                   torch.cat(hb._segments(vol)).long(), hb.n_blocks(l2t))
    rows = torch.zeros((key.shape[0], hb.LANES), dtype=torch.float32, device=DEV)
    rows.scatter_(1, lane, val)
    idx, table = key >> 32, torch.zeros((int(np.prod(shape[:2])), hb.LANES), device=DEV)
    del lane, val, key
    torch.use_deterministic_algorithms(True)
    try:
        return cuda_time(lambda: table.index_add_(0, idx, rows))
    finally:
        torch.use_deterministic_algorithms(False)


def scatter_case(calls: list, label: str, library: bool = False,
                 time_plain: bool = True) -> dict:
    """K3 as the step calls it: each call's (g, prim, bias, pts, vol,
    log2_table_size, table_shape) scattered, the gradients summed, against
    the plain version bit for bit (K3 sums in its plain version's order)
    and against a second run of itself bit for bit (``max_abs_err`` is the
    larger difference: 0). The bound: g, points and volumes read, and each
    call's output, the dense [16, nb, 128] gradient, written once (K3
    stores every row of it). With ``library``, ``k3_library_ms``; without
    ``time_plain`` the plain version is run once, not timed."""
    from f2nerf_torch.fields import hash_block as hb

    def run(fn):
        d = None
        for a in calls:
            x = fn(*a)
            d = x if d is None else d + x
        return d

    d_k, d_p = run(hb.hash_block_bwd), run(hb.hash_block_bwd_plain)
    d_again = run(hb.hash_block_bwd)
    torch.cuda.synchronize()
    err = max((d_k - d_p).abs().max().item(), (d_k - d_again).abs().max().item())
    same, repeat = bits_equal(d_k, d_p), bits_equal(d_k, d_again)
    differ = int((d_k.view(torch.int32) != d_p.view(torch.int32)).sum())
    scale = d_p.abs().max().item()
    del d_k, d_p, d_again
    ms = cuda_time(lambda: run(hb.hash_block_bwd))
    plain_ms = cuda_time(lambda: run(hb.hash_block_bwd_plain)) if time_plain else None
    _, prim, bias, _, _, l2t, shape = calls[0]
    pts = torch.cat([p for a in calls for p in hb._segments(a[3])])
    vol = torch.cat([v for a in calls for v in hb._segments(a[4])])
    n, rows = pts.shape[0], touched_rows(prim, bias, pts, vol, l2t)
    bound = bound_ms(n * (128 + 12 + 4) + len(calls) * 4 * int(np.prod(shape)))
    lib_ms = k3_library_ms(calls) if library else None
    log(f"[kernels] K3 hash_block_bwd {label}: n={n} in {len(calls)} call(s), "
        f"{rows} rows touched: bit for bit its plain version {same} ({differ} entries "
        f"differ; max|grad| {scale:.3e}), a second run bit for bit {repeat}; kernel "
        f"{ms:.4f} ms, plain {plain_ms if plain_ms is None else round(plain_ms, 4)} ms, "
        f"bound {bound:.4f} ms ({100 * bound / ms:.1f}% of it)"
        + (f"; index_add_ of the dense rows, deterministic {lib_ms:.4f} ms" if library else ""))
    if not (same and repeat):
        raise AssertionError(f"hash_block_bwd ({label}): bit for bit its plain version "
                             f"{same} ({differ} entries differ), a second run {repeat}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, n=n,
                rows=rows, library_ms=lib_ms)


def k3_uniform_args(gen, n: int = 393216, nv: int = 431, l2t: int = 19) -> tuple:
    """K3's uniform shape: n uniform points, a uniformly random volume of
    nv per sample (the worst case for row locality), g ~ N(0, 1), at
    log2_table_size l2t: hash_block_bwd's arguments."""
    from f2nerf_torch.fields import hash_block as hb
    from f2nerf_torch.fields.hash_encoding import _random_primes
    dev = torch.device(DEV)
    seeds = torch.randint(1 << 28, 1 << 30, (16 * nv * 3,), generator=gen, device=dev)
    prim = torch.from_numpy(_random_primes(seeds.cpu().numpy()).astype(np.int32)
                            .reshape(16, nv, 3)).to(dev)
    bias = torch.rand((16, nv, 3), generator=gen, device=dev) * 1000.0 + 100.0
    pts = torch.rand((n, 3), generator=gen, device=dev)
    vol = torch.randint(0, nv, (n,), generator=gen, device=dev).to(torch.int32)
    g = torch.randn((n, 32), generator=gen, device=dev)
    return g, prim, bias, pts, vol, l2t, (16, hb.n_blocks(l2t), hb.LANES)


def k3_skew_args(gen, n: int = 1 << 18) -> tuple:
    """K3's skewed case: every sample within 1e-7 of one point in one
    volume, so each level has one row holding all n samples (the coarse
    levels' skew taken to its end; 4,096 windows of that row)."""
    g, prim, bias, _, _, l2t, shape = k3_uniform_args(gen, n)
    pts = torch.tensor([0.31, 0.62, 0.27], device=DEV) + \
        torch.rand((n, 3), generator=gen, device=DEV) * 1e-7
    vol = torch.full((n,), 7, dtype=torch.int32, device=DEV)
    return g, prim, bias, pts, vol, l2t, shape


def k3_extra_cases(gen) -> dict:
    """K3 bit for bit its plain version and a second run of itself where
    the sort and the windows are large: ``n2e20`` (2^20 uniform samples:
    many waves of every launch) and ``l2t20`` (log2_table_size 20, 32,768
    rows a level, as confs/wanjinyou_big.yaml)."""
    out = {}
    for name, args in (("n2e20", k3_uniform_args(gen, n=1 << 20)),
                       ("l2t20", k3_uniform_args(gen, l2t=20))):
        out[name] = scatter_case([args], name, time_plain=False)
        del args
        torch.cuda.empty_cache()
    return out


def hash3d_entries(prim, bias, pts, vol, l2t: int) -> int:
    """Distinct pool entries (8 B each) these samples' corners touch: K5
    must read that many."""
    from f2nerf_torch.fields import hash_encoding as he
    idx = [i for _, i, _ in he._corner_indices_weights(prim, bias, pts, vol, l2t)]
    return int(torch.unique(torch.cat(idx)).numel())


def hash3d_encode_case(args: tuple, label: str) -> dict:
    """K5 against its plain version on one input (pool, prim, bias, pts,
    vol, log2_table_size), held bit for bit; the median time of both and
    the bound: points and volumes read, the touched pool entries read
    once, the encodings written."""
    from f2nerf_torch.fields import hash_encoding as he
    _, prim, bias, pts, vol, l2t = args
    out_k, out_p = he.hash_encode_fwd(*args), he.hash_encode_fwd_plain(*args)
    torch.cuda.synchronize()
    err = (out_k - out_p).abs().max().item()
    same = torch.equal(out_k, out_p)
    del out_k, out_p
    ms = cuda_time(lambda: he.hash_encode_fwd(*args))
    plain_ms = cuda_time(lambda: he.hash_encode_fwd_plain(*args), reps=3)
    n, entries = pts.shape[0], hash3d_entries(prim, bias, pts, vol, l2t)
    bound = bound_ms(n * (12 + 4) + entries * 8 + n * 128)
    log(f"[kernels] K5 hash_encode_fwd {label}: n={n}, {entries} pool entries "
        f"touched: max_abs_err {err:.3e} (bit for bit: {same}); kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({100 * bound / ms:.1f}% of it); "
        f"library call: none")
    if not same:
        raise AssertionError(f"hash_encode_fwd is not bit for bit its plain "
                             f"version ({label}): {err}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, n=n,
                entries=entries)


def k6_library_ms(args: tuple) -> float:
    """The library yardstick for K6, as K3's: one index_add_ of every
    active (entry, value) record (the plain version's, hash_encoding.
    k6_records) into a zeroed [pool, 2] gradient, under
    torch.use_deterministic_algorithms(True): the scatter alone (building
    the records and zeroing the gradient are not timed)."""
    from f2nerf_torch.fields import hash_encoding as he
    g, prim, bias, pts, vol, l2t, pool = args
    entry, val = he.k6_records(g, prim, bias, pts, vol, l2t)
    d = torch.zeros((pool, he.N_CHANNELS), dtype=torch.float32, device=DEV)
    torch.use_deterministic_algorithms(True)
    try:
        return cuda_time(lambda: d.index_add_(0, entry, val))
    finally:
        torch.use_deterministic_algorithms(False)


def hash3d_scatter_case(args: tuple, label: str, library: bool = False,
                        time_plain: bool = True) -> dict:
    """K6 against its plain version on one input (g, prim, bias, pts, vol,
    log2_table_size, pool_size), bit for bit (K6 sums in its plain
    version's order), and against a second run of itself bit for bit
    (``max_abs_err`` is the larger difference: 0). The bound: g, points
    and volumes read, the dense [pool, 2] gradient written once (K6 stores
    every entry of it). With ``library``, ``k6_library_ms``; without
    ``time_plain`` the plain version is run once, not timed."""
    from f2nerf_torch.fields import hash_encoding as he
    g, _, _, pts, _, _, pool = args
    d_k, d_p = he.hash_encode_bwd(*args), he.hash_encode_bwd_plain(*args)
    d_again = he.hash_encode_bwd(*args)
    torch.cuda.synchronize()
    same, repeat = bits_equal(d_k, d_p), bits_equal(d_k, d_again)
    err = max((d_k - d_p).abs().max().item(), (d_k - d_again).abs().max().item())
    differ = int((d_k.view(torch.int32) != d_p.view(torch.int32)).sum())
    scale = d_p.abs().max().item()
    del d_k, d_p, d_again
    ms = cuda_time(lambda: he.hash_encode_bwd(*args))
    plain_ms = cuda_time(lambda: he.hash_encode_bwd_plain(*args), reps=3) if time_plain \
        else None
    n = pts.shape[0]
    zero = int((g.abs().amax(dim=1) == 0).sum())
    bound = bound_ms(n * (128 + 12 + 4) + pool * 8)
    lib_ms = k6_library_ms(args) if library else None
    log(f"[kernels] K6 hash_encode_bwd {label}: n={n} ({zero} zero-gradient rows), "
        f"pool {pool}: bit for bit its plain version {same} ({differ} entries differ; "
        f"max|grad| {scale:.3e}), a second run bit for bit {repeat}; kernel {ms:.4f} ms, "
        f"plain {plain_ms if plain_ms is None else round(plain_ms, 4)} ms, bound "
        f"{bound:.4f} ms ({100 * bound / ms:.1f}% of it)"
        + (f"; index_add_ of the records, deterministic {lib_ms:.4f} ms" if library else ""))
    if not (same and repeat):
        raise AssertionError(f"hash_encode_bwd ({label}): bit for bit its plain version "
                             f"{same} ({differ} entries differ), a second run {repeat}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, n=n,
                library_ms=lib_ms)


def k6_args(gen, n: int = 393216, nv: int = 431, l2t: int = 19, skew: bool = False) -> tuple:
    """K6's input at the uniform shape (k3_uniform_args' points, volumes
    and g: hash_encode_bwd's arguments at log2_table_size l2t), or with
    ``skew`` every sample within 1e-7 of one point in one volume (each
    level's 8 entries take every record)."""
    from f2nerf_torch.fields.hash_encoding import N_LEVELS, local_size
    g, prim, bias, pts, vol, _, _ = k3_uniform_args(gen, n, nv, l2t)
    if skew:
        pts = torch.tensor([0.31, 0.62, 0.27], device=DEV) + pts * 1e-7
        vol = torch.full_like(vol, 7)
    return g, prim, bias, pts, vol, l2t, N_LEVELS * local_size(l2t)


def k6_extra_cases(gen) -> dict:
    """K6 bit for bit its plain version and a second run of itself at
    ``skew`` (2^18 samples in one cell a level), ``n2e20`` (2^20 uniform
    samples) and ``l2t20`` (log2_table_size 20, as confs/wanjinyou_big.yaml
    sizes HashBlock), each one's row by name."""
    out = {}
    for name, make in (("skew", lambda: k6_args(gen, n=1 << 18, skew=True)),
                       ("n2e20", lambda: k6_args(gen, n=1 << 20)),
                       ("l2t20", lambda: k6_args(gen, l2t=20))):
        out[name] = hash3d_scatter_case(make(), name, time_plain=False)
        torch.cuda.empty_cache()
    return out


def baseline_k6(root: str):
    """ROOT's K6 (its csrc/hash3d.cu: float2 atomics into a pool gradient
    that its wrapper zero-filled), built alone with nvcc (the package's
    flags) into f2nerf_torch/_build/baseline/. Returns a function of
    hash_encode_bwd's arguments that zero-fills the gradient and launches
    ROOT's K6 into it, as ROOT's wrapper did."""
    from f2nerf_torch import kernels
    from f2nerf_torch.fields.hash_encoding import N_CHANNELS, _scales, local_size
    out = os.path.join(kernels.BUILD_DIR, "baseline")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(os.path.abspath(root), "f2nerf_torch", "csrc", "hash3d.cu")
    so = os.path.join(out, "libbaseline_k6.so")
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.f2_hash3d_bwd.argtypes = [vp] * 7 + [ll, i, i, vp]
    lib.f2_hash3d_bwd.restype = ctypes.c_int

    def run(g, prim, bias, pts, vol, l2t, pool):
        g, pts, vol = g.contiguous(), pts.contiguous(), vol.contiguous()
        d = torch.zeros((pool, N_CHANNELS), dtype=torch.float32, device=DEV)
        kernels.check(lib.f2_hash3d_bwd(
            g.data_ptr(), prim.data_ptr(), bias.data_ptr(), _scales(DEV).data_ptr(),
            pts.data_ptr(), vol.data_ptr(), d.data_ptr(), pts.shape[0], prim.shape[1],
            local_size(l2t), kernels.stream_ptr(DEV)), "baseline hash_encode_bwd")
        return d
    return run


def baseline_k6_turns(root: str, cases: dict) -> dict:
    """--baseline ROOT: ROOT's K6 with its zero-fill (``baseline_k6``) and
    this tree's K6, timed in turns (ROOT, this, this, ROOT, ...;
    cuda_time_turns) on each case's arguments, ROOT's gradient held to
    this tree's within TOL_SCATTER_REL of the largest entry (ROOT's atomics
    sum in no fixed order). K6's time by launch is the sweep's
    (scripts/sweep_kernels.py --kernels k6): a profiler session here would
    come before the profiler checks of later phases."""
    from f2nerf_torch.fields import hash_encoding as he
    theirs = baseline_k6(root)
    out = {}
    for name, args in cases.items():
        mine, old = he.hash_encode_bwd(*args), theirs(*args)
        torch.cuda.synchronize()
        err, scale = (mine - old).abs().max().item(), mine.abs().max().item()
        del mine, old
        if not (np.isfinite(err) and err <= TOL_SCATTER_REL * scale):
            raise AssertionError(f"the baseline's K6 differs from this tree's ({name}): {err}")
        t = cuda_time_turns({"baseline": lambda: theirs(*args),
                             "this tree": lambda: he.hash_encode_bwd(*args)})
        log(f"[kernels] K6 {name}, in turns with {root}: baseline K6 with its zero-fill "
            f"{t['baseline']:.4f} ms, this tree {t['this tree']:.4f} ms (max |diff| "
            f"{err:.3e}, max|grad| {scale:.3e})")
        out[name] = dict(baseline_ms=t["baseline"], turns_ms=t["this tree"],
                         baseline_max_abs_err=err)
        torch.cuda.empty_cache()
    return out


def march_case(args: tuple, label: str) -> dict:
    """K7 against its plain version on one input (tree, rays_o, rays_d,
    hit_idx, hit_near, hit_far, n_hits, noise, sample_l, scale_by_dis,
    max_s): n_s and out_node equal, out_t/out_dt to TOL_MARCH_REL
    relative. The bound is the largest of: the bytes (hit lists, rays,
    noise, the touched nodes' trans_idx and the touched leaves' warp rows
    read once, the dense outputs written once) over 3.35 TB/s; the
    operations of this run's EMIT evaluations (one per sample, plus one
    per hit entered) at MARCH_FLOPS_PER_EMIT f32 operations each over the
    card's 67 TFLOP/s f32 peak; and the chain, the longest ray's EMIT and
    ADVANCE iterations (counted by the plain version) at
    MARCH_CHAIN_EMIT / MARCH_CHAIN_ADVANCE dependent operations each,
    CYCLES_PER_OP cycles an operation at the card's max SM clock."""
    from f2nerf_torch.sampler import device as dv
    tree, _, _, hit_idx, _, _, n_hits, noise, _, _, max_s = args
    got, want = dv.ray_march(*args), dv.ray_march_plain(*args)
    iters = dv.ray_march_plain.last_iters.long().cpu()
    torch.cuda.synchronize()
    same = torch.equal(got[3], want[3]) and torch.equal(got[2], want[2])
    exact = same and all(torch.equal(got[k], want[k]) for k in (0, 1))
    rel = max(((got[k] - want[k]).abs() / want[k].abs().clamp(min=1e-30)).max().item()
              for k in (0, 1))
    err = max((got[k] - want[k]).abs().max().item() for k in (0, 1))
    n_s = int(want[3].sum())
    del got, want
    ms = cuda_time(lambda: dv.ray_march(*args))
    plain_ms = cuda_time(lambda: dv.ray_march_plain(*args), reps=3)
    R, H = hit_idx.shape
    nodes = torch.unique(hit_idx[hit_idx >= 0].long())
    leaves = torch.unique(tree.trans_idx[nodes].clamp(min=0)).numel()
    emits = n_s + int(n_hits.sum())
    nbytes = (R * H * 12 + R * 28 + noise.numel() * 4 + nodes.numel() * 4
              + leaves * (96 + 36 + 3 + 1) * 4 + R * max_s * 12 + R * 4)
    chain = iters[:, 0] * MARCH_CHAIN_EMIT + iters[:, 1] * MARCH_CHAIN_ADVANCE
    longest = int(chain.argmax())
    e_max, a_max = (int(x) for x in iters[longest])
    terms = {"bytes": bound_ms(nbytes),
             "operations": emits * MARCH_FLOPS_PER_EMIT / F32_FLOPS * 1e3,
             "chain": int(chain[longest]) * CYCLES_PER_OP / CARD["max_sm_hz"] * 1e3}
    term = max(terms, key=terms.get)
    bound = terms[term]
    bound_by = "bytes" if term == "bytes" else "operations"
    old_bound = max(terms["bytes"], terms["operations"])
    ns_per_iter = ms * 1e6 / max(e_max + a_max, 1)
    log(f"[kernels] K7 ray_march {label}: R={R}, H={H}, max_s={max_s}, {n_s} samples, "
        f"{emits} EMIT evaluations, {leaves} leaves: n_s and out_node equal: {same}; "
        f"t/dt max rel err {rel:.3e} (tol {TOL_MARCH_REL:g}), max abs {err:.3e} "
        f"(bit for bit: {exact}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound:.4f} ms by {term} (bytes {terms['bytes']:.4f}, operations "
        f"{terms['operations']:.4f}, chain {terms['chain']:.4f}; {100 * bound / ms:.1f}% "
        f"of it, {100 * old_bound / ms:.1f}% of max(bytes, operations)); longest ray "
        f"{longest}: {e_max} EMIT + {a_max} ADVANCE iterations, {ns_per_iter:.2f} ns "
        f"an iteration; EMIT/ADVANCE over all rays {int(iters[:, 0].sum())}/"
        f"{int(iters[:, 1].sum())}; library call: none")
    if not (same and rel <= TOL_MARCH_REL):
        raise AssertionError(f"ray_march disagrees with its plain version ({label})")
    return dict(max_abs_err=err, max_rel_err=rel, bit_for_bit=exact, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, bound_term=term,
                bytes_ms=terms["bytes"], operations_ms=terms["operations"],
                chain_ms=terms["chain"], longest_emit=e_max, longest_advance=a_max,
                ns_per_iter=ns_per_iter, samples=n_s, R=R, H=H)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same dtype and the same bits (float32 compared as int32)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def device_kernels(fn) -> list:
    """The names of the device activities (kernels, memsets) that one call
    of fn puts on the card, in order (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type != DeviceType.CPU]


def traverse_case(args: tuple, label: str) -> dict:
    """K8 against traverse_plain on one input (tree, rays_o, rays_d, near,
    far, max_hits[, max_iters]): hit_idx, n_hits, trunc, n_iters and each
    ray's iterations equal, hit_near and hit_far bit for bit. The bound
    is the larger of: the bytes (rays, near and far read; the hit rows,
    n_hits, trunc and the iteration counts written; the rows of the
    distinct leaves emitted read once, fewer rows than the traversal
    touches) over 3.35 TB/s, and the chain, the longest ray's iterations
    (counted by the plain version) at TRAV_CHAIN dependent operations,
    CYCLES_PER_OP cycles each at the card's max SM clock."""
    from f2nerf_torch.sampler import device as dv
    tree = args[0]
    smem = dv.traverse_smem_nodes(tree)
    got = dv.traverse(*args)
    k_iters = dv.traverse.last_iters
    want = dv.traverse_plain(*args)
    iters = dv.traverse_plain.last_iters
    torch.cuda.synchronize()
    names = ("hit_idx", "hit_near", "hit_far", "n_hits", "trunc", "n_iters")
    same = {n: bits_equal(g, w) for n, g, w in zip(names, got, want)}
    same["iters"] = bits_equal(k_iters, iters)
    err = max((got[k] - want[k]).abs().max().item() for k in (1, 2))
    R, H = want[0].shape
    n_hits, n_trunc, longest = int(want[3].sum()), int(want[4].sum()), int(iters.max())
    leaves = torch.unique(want[0][want[0] >= 0]).numel()
    del got, want
    ms = cuda_time(lambda: dv.traverse(*args))
    plain_ms = cuda_time(lambda: dv.traverse_plain(*args), reps=3)
    nbytes = R * (12 + 12 + 4 + 4) + leaves * TRAV_NODE_BYTES + R * H * 12 + R * 13 + 4
    terms = {"bytes": bound_ms(nbytes),
             "chain": longest * TRAV_CHAIN * CYCLES_PER_OP / CARD["max_sm_hz"] * 1e3}
    term = max(terms, key=terms.get)
    bound = terms[term]
    where = f"shared memory ({smem} nodes)" if smem else \
        f"global memory ({tree.n_nodes} nodes > {dv.TRAVERSE_SMEM_NODES})"
    log(f"[kernels] K8 traverse {label}: tree in {where}; R={R}, H={H}, {n_hits} hits, "
        f"{n_trunc} truncated, {leaves} leaves; iterations: loop {longest}, mean a ray "
        f"{float(iters.float().mean()):.1f}; equal (floats bit for bit): {same}; "
        f"max abs err {err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound:.4f} ms by {term} (bytes {terms['bytes']:.4f}, chain {terms['chain']:.4f}; "
        f"{100 * bound / ms:.1f}% of it); {ms * 1e6 / max(longest, 1):.2f} ns an "
        f"iteration of the longest ray; library call: none")
    if not all(same.values()):
        raise AssertionError(f"traverse disagrees with traverse_plain ({label}): {same}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                nodes=tree.n_nodes, smem_nodes=smem,
                bound_by="bytes" if term == "bytes" else "operations", bound_term=term,
                bytes_ms=terms["bytes"], chain_ms=terms["chain"], longest_iters=longest,
                mean_iters=float(iters.float().mean()), hits=n_hits, truncated=n_trunc,
                leaves=leaves, R=R, H=H)


def march_parallel_case(args: tuple, label: str) -> dict:
    """K9 against ray_march_parallel_plain on one input (tree, rays_o,
    rays_d, hit_idx, hit_near, hit_far, n_hits, jitter, fineness,
    sample_l, scale_by_dis, max_s): all five outputs bit for bit. The
    bound is bytes: the valid hit entries and n_hits, the rays, the
    jitter of the slots filled, the fineness, the trans_idx of the
    distinct nodes and the warp rows of the distinct leaves read once;
    the dense outputs, n_samples and first_oct written once."""
    from f2nerf_torch.sampler import device as dv
    tree, _, _, hit_idx, _, _, n_hits, _, _, _, scale_by_dis, max_s = args
    got = dv.ray_march_parallel(*args)
    want = dv.ray_march_parallel_plain(*args)
    torch.cuda.synchronize()
    names = ("out_t", "out_dt", "out_node", "n_samples", "first_oct")
    same = {n: bits_equal(g, w) for n, g, w in zip(names, got, want)}
    err = max((got[k] - want[k]).abs().max().item() for k in (0, 1, 4))
    n_s = int(want[3].sum())
    R, H = hit_idx.shape
    del got, want
    ms = cuda_time(lambda: dv.ray_march_parallel(*args))
    plain_ms = cuda_time(lambda: dv.ray_march_parallel_plain(*args), reps=3)
    valid = torch.arange(H, device=hit_idx.device)[None, :] < n_hits[:, None]
    nodes = torch.unique(hit_idx[valid].long())
    leaves = torch.unique(tree.trans_idx[nodes].clamp(min=0)).numel()
    n_h = int(n_hits.sum())
    nbytes = (n_h * 12 + R * 4 + R * 24 + n_s * 4 + 4 + nodes.numel() * 4
              + leaves * (96 + 36 + 3 + 1) * 4 + R * max_s * 12 + R * 8)
    bound = bound_ms(nbytes)
    geo = dv.ray_march_parallel_geometry(H)
    log(f"[kernels] K9 ray_march_parallel {label}: R={R}, H={H}, max_s={max_s}, "
        f"scale_by_dis={scale_by_dis}, {n_h} hits, {n_s} samples, {leaves} leaves; "
        f"{geo['ray_threads']} threads a ray, {geo['rays_per_block']} rays a block: "
        f"bit for bit {same}; max abs err {err:.3e}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms by bytes ({100 * bound / ms:.1f}% "
        f"of it); library call: none")
    if not all(same.values()):
        raise AssertionError(f"ray_march_parallel disagrees with its plain version "
                             f"({label}): {same}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes", samples=n_s, hits=n_h, R=R, H=H, max_s=max_s,
                ray_threads=geo["ray_threads"], rays_per_block=geo["rays_per_block"])


def segment_reduce_case(x, ray_id, n_rays: int, offsets, label: str) -> dict:
    """K10 against segment_sum_plain (index_add) on one input, with the
    offsets given (``offsets``, from the offsets launch): within
    TOL_SEG_SUM_REL of each ray's sum of |x|, a repeated launch bit for bit;
    the median time of both and of the library call torch.segment_reduce
    (the rays' lengths and one more segment for the padding, counted
    before timing; unsafe=True skips its host-side checks). Bound: the
    valid rows and the offsets read once, [R, C] written."""
    from f2nerf_torch.ops import segment as sg
    got = sg.segment_reduce(x, ray_id, n_rays, offsets)
    again = sg.segment_reduce(x, ray_id, n_rays, offsets)
    want = sg.segment_sum_plain(x, ray_id, n_rays)
    scale = sg.segment_sum_plain(x.abs(), ray_id, n_rays)
    lengths = torch.bincount(ray_id.long(), minlength=n_rays + 1)

    def library():
        return torch.segment_reduce(x, "sum", lengths=lengths, axis=0, unsafe=True)

    try:
        lib_err = (library()[:n_rays] - want).abs().max().item() if n_rays else 0.0
    except RuntimeError as e:          # the yardstick only; the port never calls it
        log(f"[kernels] torch.segment_reduce refused this input ({label}): {e}")
        library = None
    torch.cuda.synchronize()
    repeat = bits_equal(got, again)
    diff = (got - want).abs()
    err = diff.max().item() if diff.numel() else 0.0
    held = bool((diff <= TOL_SEG_SUM_REL * scale).all())
    rel = (diff / scale.clamp(min=1e-30)).max().item() if diff.numel() else 0.0
    c = 1 if x.dim() == 1 else x.shape[1]
    n_valid = int((ray_id < n_rays).sum())
    del got, again, want, scale, diff
    ms = cuda_time(lambda: sg.segment_reduce(x, ray_id, n_rays, offsets))
    plain_ms = cuda_time(lambda: sg.segment_sum_plain(x, ray_id, n_rays))
    library_ms = cuda_time(library) if library else None
    lib_err = lib_err if library else None
    bound = bound_ms(n_valid * c * 4 + (n_rays + 1) * 4 + n_rays * c * 4)
    ld = x.stride(0) if x.dim() == 2 and x.stride(-1) == 1 else c
    vec = c % 4 == 0 and 32 % (c // 4) == 0 and ld % 4 == 0 and x.data_ptr() % 16 == 0
    log(f"[kernels] K10 segment_reduce {label}: x {tuple(x.shape)} (row stride {ld}), "
        f"R={n_rays}, {n_valid} valid rows, {'vector' if vec else 'scalar'} path: "
        f"max_abs_err {err:.3e}, "
        f"largest error over the ray's sum of |x| {rel:.3e} (tol {TOL_SEG_SUM_REL:g}); "
        f"repeated launch bit for bit: {repeat}; kernel {ms:.4f} ms, plain (index_add) "
        f"{plain_ms:.4f} ms, torch.segment_reduce {library_ms} ms (max_abs_err {lib_err}); "
        f"bound {bound:.4f} ms by bytes ({100 * bound / ms:.1f}% of it)")
    if not (held and repeat):
        raise AssertionError(f"segment_reduce disagrees with its plain version or "
                             f"repeats differently ({label})")
    return dict(max_abs_err=err, max_rel_err=rel, repeat_bit_for_bit=repeat, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, library_max_abs_err=lib_err,
                bound_ms=bound, rows=x.shape[0], valid_rows=n_valid, R=n_rays, C=c,
                row_stride=ld, path="vector" if vec else "scalar")


def ray_offsets_case(ray_id, n_rays: int, label: str, given=None) -> dict:
    """The offsets launch against ray_offsets_plain on one input, computed
    and with the offsets given (``given``: as the single-pass step launches
    it on K12's offsets, which must equal the plain version's; None: the
    plain version's): offsets, counts, local_index and first equal
    (torch.equal), a repeated launch equal; the median time of each and,
    beside them, torch.searchsorted (the offsets alone, no single PyTorch
    call gives all four). Bound: ray_id read once, the outputs written once
    (given: the offsets read instead of written, the same bytes). (One
    device launch a call: segment_uniform_rows.)"""
    from f2nerf_torch.ops import segment as sg
    want = sg.ray_offsets_plain(ray_id, n_rays)
    same = {}
    if given is None:
        given = want[0].clone()
    else:
        same["given offsets"] = torch.equal(given, want[0])
    runs = {"computed": (lambda: sg.ray_offsets(ray_id, n_rays)),
            "given": (lambda: sg.ray_offsets(ray_id, n_rays, given))}
    names = ("offsets", "counts", "local_index", "first")
    err = 0.0
    for form, fn in runs.items():
        got, again = fn(), fn()
        torch.cuda.synchronize()
        same.update({f"{form} {k}": torch.equal(g, w) for k, g, w in zip(names, got, want)})
        same[f"{form} repeat"] = all(torch.equal(g, w) for g, w in zip(got, again))
        err = max([err] + [float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
                           for g, w in zip(got, want)])
        del got, again
    del want
    keys = torch.arange(n_rays + 1, dtype=ray_id.dtype, device=ray_id.device)
    ms = cuda_time(runs["computed"])
    given_ms = cuda_time(runs["given"])
    plain_ms = cuda_time(lambda: sg.ray_offsets_plain(ray_id, n_rays))
    search_ms = cuda_time(lambda: torch.searchsorted(ray_id, keys))
    n = ray_id.shape[0]
    bound = bound_ms(n * 4 + (n_rays + 1) * 4 + n_rays * 4 + n * 5)
    ok = all(same.values())
    log(f"[kernels] ray_offsets {label}: n={n}, R={n_rays}: all equal {ok if ok else same}; "
        f"kernel {ms:.4f} ms, offsets given {given_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.searchsorted (offsets alone) {search_ms:.4f} ms; bound {bound:.4f} ms by "
        f"bytes ({100 * bound / ms:.1f}% of it; given {100 * bound / given_ms:.1f}%)")
    if not ok:
        raise AssertionError(f"ray_offsets disagrees with its plain version ({label}): {same}")
    return dict(max_abs_err=err, ms=ms, given_ms=given_ms, plain_ms=plain_ms, bound_ms=bound,
                searchsorted_ms=search_ms, n=n, R=n_rays)


def segment_scan_case(x, is_first, exclusive: bool, reverse: bool, label: str) -> dict:
    """K11 against segment_cumsum_plain on one input: rtol/atol TOL_SCAN, a
    repeated launch bit for bit; the median time of both. Bound: x and the
    flags read once, the output written."""
    from f2nerf_torch.ops import segment as sg
    got = sg.segment_scan(x, is_first, exclusive, reverse)
    again = sg.segment_scan(x, is_first, exclusive, reverse)
    want = sg.segment_cumsum_plain(x, is_first, exclusive, reverse)
    torch.cuda.synchronize()
    repeat = bits_equal(got, again)
    diff = (got - want).abs()
    err = diff.max().item() if diff.numel() else 0.0
    held = bool((diff <= TOL_SCAN + TOL_SCAN * want.abs()).all())
    n = x.shape[0]
    n_seg = int(is_first.sum())
    del got, again, want, diff
    ms = cuda_time(lambda: sg.segment_scan(x, is_first, exclusive, reverse))
    plain_ms = cuda_time(lambda: sg.segment_cumsum_plain(x, is_first, exclusive, reverse))
    bound = bound_ms(n * (4 + 1 + 4))
    log(f"[kernels] K11 segment_scan {label}: n={n}, {n_seg} flags, exclusive "
        f"{exclusive}, reverse {reverse}: max_abs_err {err:.3e} (rtol/atol {TOL_SCAN:g}); "
        f"repeated launch bit for bit: {repeat}; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms; bound {bound:.4f} ms by bytes "
        f"({100 * bound / ms:.1f}% of it); library call: none")
    if not (held and repeat):
        raise AssertionError(f"segment_scan disagrees with its plain version or "
                             f"repeats differently ({label})")
    return dict(max_abs_err=err, repeat_bit_for_bit=repeat, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, n=n, flags=n_seg, exclusive=exclusive, reverse=reverse)


def segment_uniform_rows(gen) -> list[dict]:
    """K10 (C = 1, 2, 6 and 16, the offsets given), K11 (forward exclusive
    and its reverse) and the offsets launch at SEG_RAYS rays of SEG_PER_RAY
    samples, x from U[0, 1); the offsets launch also at SEG_RAYS rays of
    U[0, 2 SEG_PER_RAY) samples, a tenth of them none, padded to
    SEG_RAYS x SEG_PER_RAY rows (``padded_`` keys). K10's row keeps C = 6's
    numbers; the offsets launch's row the given form's (the form the
    single-pass path launches; variants (b) replaces them with its step's
    own)."""
    from f2nerf_torch.ops import segment as sg
    dev = torch.device(DEV)
    rid = torch.arange(SEG_RAYS, device=dev, dtype=torch.int32).repeat_interleave(SEG_PER_RAY)
    first = sg.first_flags_from_ray_id(rid, SEG_RAYS)
    shape = f"{SEG_RAYS} rays x {SEG_PER_RAY}"
    r0 = ray_offsets_case(rid, SEG_RAYS, f"uniform {shape}")
    counts = torch.randint(0, 2 * SEG_PER_RAY, (SEG_RAYS,), generator=gen, device=dev)
    counts[torch.rand((SEG_RAYS,), generator=gen, device=dev) < 0.1] = 0
    pad = torch.repeat_interleave(torch.arange(SEG_RAYS, device=dev), counts)[:rid.shape[0]]
    pad = torch.cat([pad, torch.full((rid.shape[0] - pad.shape[0],), SEG_RAYS, device=dev)])
    r_pad = ray_offsets_case(pad.to(torch.int32), SEG_RAYS,
                             f"{SEG_RAYS} rays of 0-{2 * SEG_PER_RAY - 1}, empty rays, padding")
    offsets = sg.ray_offsets(rid, SEG_RAYS)[0]
    r10 = {}
    for c in (1, 2, 6, 16):
        x = torch.rand((rid.shape[0], c), generator=gen, device=dev)
        r = segment_reduce_case(x[:, 0].contiguous() if c == 1 else x, rid, SEG_RAYS,
                                offsets, f"uniform {shape}, C {c}")
        r10.update({f"uniform_c{c}_{k}": v for k, v in r.items()})
    x = torch.rand(rid.shape, generator=gen, device=dev)
    r11 = {f"uniform_{d}_{k}": v for d, rev in (("forward", False), ("reverse", True))
           for k, v in segment_scan_case(x, first, True, rev, f"uniform {shape}").items()}
    # one launch a call: what an offsets call and a forward and a reverse
    # scan put on the card (one profiler session: a later session in the
    # process may see no device events; the profile phase's is the only
    # other)
    on_card = device_kernels(lambda: (sg.ray_offsets(rid, SEG_RAYS),
                                      sg.segment_scan(x, first, True, False),
                                      sg.segment_scan(x, first, True, True)))
    log(f"[kernels] an offsets call and a forward and a reverse K11 call put {on_card} "
        f"on the card")
    if len(on_card) != 3 or "ray_offsets" not in on_card[0] \
            or not all("segment_scan" in k for k in on_card[1:]):
        raise AssertionError(f"ray_offsets / segment_scan: expected one launch a call, "
                             f"got {on_card}")
    r11["device_launches_a_call"] = 1
    r0["device_launches_a_call"] = 1
    pick = ("max_abs_err", "ms", "plain_ms", "bound_ms")
    return [dict(name="ray_offsets", route="cuda", source="f2nerf_torch/csrc/segment.cu",
                 replaces="f2nerf_tpu/ops/segment.py:65", bound_by="bytes", library_ms=None,
                 library="none: no single PyTorch call gives the offsets, counts, local "
                         "index and first flags (torch.searchsorted, the offsets alone, "
                         "timed beside)", path="variants (b)",
                 **{f"uniform_{k}": v for k, v in r0.items()},
                 **{f"padded_{k}": v for k, v in r_pad.items()},
                 max_abs_err=max(r0["max_abs_err"], r_pad["max_abs_err"]), ms=r0["given_ms"],
                 plain_ms=r0["plain_ms"], bound_ms=r0["bound_ms"]),
            dict(name="segment_reduce", route="cuda", source="f2nerf_torch/csrc/segment.cu",
                 replaces="f2nerf_tpu/ops/segment.py:23", bound_by="bytes",
                 library="torch.segment_reduce", **r10,
                 **{k: r10[f"uniform_c6_{k}"] for k in pick + ("library_ms",)}),
            dict(name="segment_scan", route="cuda", source="f2nerf_torch/csrc/segment.cu",
                 replaces="f2nerf_tpu/ops/segment.py:38", bound_by="bytes",
                 library_ms=None, library=NO_LIBRARY_SCAN, **r11,
                 **{k: r11[f"uniform_forward_{k}"] for k in pick})]


def segment_step_cases(calls: dict) -> dict:
    """K10, K11 and the offsets launch at one step's own inputs (every call,
    spied): each call checked and timed; a row's ms, plain_ms, bound_ms and
    library_ms become the sums over the step's calls (the kernel's device
    time a step)."""
    out = {}
    for name, fn in (("ray_offsets", lambda a: ray_offsets_case(*a, "step call")),
                     ("segment_reduce", lambda a: segment_reduce_case(
            *a, f"step call, x {tuple(a[0].shape)}")),
                     ("segment_scan", lambda a: segment_scan_case(
            *a, f"step call{' (backward)' if a[3] else ''}"))):
        rs = [fn(a) for a in calls[name]]
        if not rs:                     # the two-pass step: K13 writes B's segments
            continue
        tot = {k: sum(r[k] for r in rs) for k in ("ms", "plain_ms", "bound_ms")}
        if name == "segment_reduce":
            lib = [r["library_ms"] for r in rs]
            tot["library_ms"] = None if None in lib else sum(lib)
        out[name] = dict(tot, max_abs_err=max(r["max_abs_err"] for r in rs),
                         calls=rs, n_calls=len(rs))
        log(f"[kernels] {name} at one slice step's {len(rs)} calls: kernel "
            f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, bound "
            f"{tot['bound_ms']:.4f} ms a step"
            + (f", torch.segment_reduce {tot['library_ms']} ms" if "library_ms" in tot
               else ""))
    return out


# ---------------------------------------------- K12, K13, K14 (exact kernels)

def out_leaves(x, name: str = "") -> list:
    """The tensors of a kernel's output (nested tuples and dicts), named."""
    if torch.is_tensor(x):
        return [(name, x)]
    if isinstance(x, dict):
        return [leaf for k in sorted(x) for leaf in out_leaves(x[k], f"{name}.{k}")]
    return [leaf for i, v in enumerate(x) for leaf in out_leaves(v, f"{name}[{i}]")]


def exact_case(tag: str, label: str, kernel, plain, nbytes: float, library=None,
               library_name: str = "library call: none") -> dict:
    """A kernel against its plain version on one input (each a function of
    no argument): every output bit for bit (floats as their int32 bits, so
    a NaN must be the same NaN) and a repeated launch bit for bit; the
    median time of the kernel, of the plain version and of ``library``
    (one PyTorch call for the function or its main part), and the bound,
    nbytes over 3.35 TB/s."""
    got, again, want = out_leaves(kernel()), out_leaves(kernel()), out_leaves(plain())
    torch.cuda.synchronize()
    same = {n: bits_equal(g, w) for (n, g), (_, w) in zip(got, want)}
    repeat = all(bits_equal(g, a) for (_, g), (_, a) in zip(got, again))
    err = 0.0
    for (_, g), (_, w) in zip(got, want):
        g, w = g.double(), w.double()
        fin = torch.isfinite(g) & torch.isfinite(w)
        if not torch.equal(torch.isfinite(g), torch.isfinite(w)):
            err = float("inf")
        elif bool(fin.any()):
            err = max(err, (g - w)[fin].abs().max().item())
    del got, again, want
    ms = cuda_time(kernel)
    plain_ms = cuda_time(plain, reps=5)
    library_ms = cuda_time(library) if library is not None else None
    bound = bound_ms(nbytes)
    ok = all(same.values())
    log(f"[kernels] {tag} {label}: bit for bit {ok if ok else same}; repeated launch bit "
        f"for bit: {repeat}; max abs err {err:.3e}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, {library_name}"
        + (f" {library_ms:.4f} ms" if library_ms is not None else "")
        + f"; bound {bound:.4f} ms by bytes ({100 * bound / ms:.1f}% of it)")
    if not (ok and repeat):
        raise AssertionError(f"{tag} disagrees with its plain version or repeats "
                             f"differently ({label}): {same}, repeat {repeat}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound, bound_by="bytes", bytes=nbytes, repeat_bit_for_bit=repeat)


def compact_a_case(args: tuple, label: str) -> dict:
    """K12's compact_a_warp on (tree, n_s, out_t, out_dt, out_node, rays_o,
    rays_d, cap). Bound: n_s, the used slots' t, dt and node, the rays, the
    distinct nodes' trans_idx and the distinct leaves' warp rows read once,
    45 bytes a slot and the R + 1 offsets written. The offsets are also
    held to the offsets launch's for the kernel's ray ids, and the offsets
    launch given them, all four outputs and a repeat, to its plain version
    on the kernel's padded A (``ray_offsets_case``)."""
    from f2nerf_torch.render import renderer as rd
    tree, n_s, out_t = args[:3]
    cap = args[-1]
    R, max_s = out_t.shape
    total = int(n_s.long().sum())
    a, _, ok, _ = rd.compact_a_warp_plain(*args)
    nodes = torch.unique(a["node"][ok]).numel()
    leaves = torch.unique(a["trans"][ok]).numel()
    del a, ok
    nbytes = (R * 4 + min(total, cap) * 12 + R * 24 + nodes * 4 + leaves * 132 * 4 + cap * 45
              + (R + 1) * 4)
    r = exact_case("K12 compact_a_warp", f"{label}: R={R}, max_s={max_s}, cap={cap}, "
                   f"{total} samples, {leaves} leaves", lambda: rd.compact_a_warp(*args),
                   lambda: rd.compact_a_warp_plain(*args), nbytes)
    # A's offsets equal the offsets launch's, and the offsets launch given
    # them (as a single-pass step launches it on A) is its plain version
    _, rid, _, offsets = rd.compact_a_warp(*args)
    off = ray_offsets_case(rid, R, f"{label}: K12's A and offsets", given=offsets)
    return dict(r, R=R, max_s=max_s, cap=cap, samples=total, leaves=leaves,
                offsets_equal_offsets_launch=True, offsets_launch_given_ms=off["given_ms"],
                offsets_launch_ms=off["ms"], offsets_launch_bound_ms=off["bound_ms"])


def edges_case(args: tuple, label: str) -> dict:
    """K12's sample_edges on (tree, edge_idx, coord). Bound: the picks and
    coordinates, the distinct edges' rows and their leaves' warp rows read
    once, 32 bytes a sample written."""
    from f2nerf_torch.sampler import device as dv
    tree, e, _ = args
    n = e.shape[0]
    edges = torch.unique(e.long())
    leaves = torch.unique(tree.edge_t[edges].reshape(-1)).numel()
    nbytes = n * 12 + edges.numel() * 44 + leaves * 132 * 4 + n * 32
    r = exact_case("K12 sample_edges", f"{label}: n={n}, {edges.numel()} edges",
                   lambda: dv.sample_edges(*args), lambda: dv.sample_edges_plain(*args), nbytes)
    return dict(r, n=n)


def keep_case(args: tuple, label: str) -> dict:
    """K13 on (keep, cap, fields, rid_src, n_rays): B and B's segments
    (offsets, counts, local indices, first flags) bit for bit. Bound: the
    flags and A's ray ids read once, the kept rows' 40 bytes of fields
    read once, 53 bytes a slot and the segments (5 bytes a slot, 8 a ray)
    written. Beside it, torch.nonzero_static (B's indices alone) where the
    card's torch has it on CUDA."""
    from f2nerf_torch.render import renderer as rd
    keep, cap = args[:2]
    n, kept, R = keep.shape[0], int(keep.sum()), args[4]
    r = exact_case("K13 compact_keep", f"{label}: n={n}, cap={cap}, R={R}, {kept} kept",
                   lambda: rd.compact_keep(*args), lambda: rd.compact_keep_plain(*args),
                   n * 5 + min(kept, cap) * 40 + cap * (53 + 5) + R * 8 + 4)
    try:
        nz = cuda_time(lambda: torch.nonzero_static(keep, size=cap, fill_value=n))
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        log(f"[kernels] torch.nonzero_static refused this input: {e}")
        nz = None
    return dict(r, n=n, cap=cap, kept=kept, nonzero_static_ms=nz)


def votes_case(args: tuple, label: str) -> dict:
    """K14's votes on (tree, node, rid, w, a, n_rays[, offsets]): given
    the offsets (as the renderer passes buffer A's or B's; made by the
    offsets launch where the case has none) and without them (the wrapper
    computes them). Bound: the offsets, node of the rays' rows and w and a
    of their valid rows read once, the four [N] votes written. Library:
    one scatter_reduce amax of the weight votes into [N + 1] (its inputs
    made before timing)."""
    from f2nerf_torch.ops import segment as sg
    from f2nerf_torch.sampler import device as dv
    tree, node, rid, w, a, n_rays = args[:6]
    if len(args) == 6:
        args = args + (sg.ray_offsets(rid, n_rays)[0],)
    n, N = node.shape[0], tree.trans_idx.shape[0]
    valid = (rid < n_rays) & (node >= 0)
    n_valid = int(valid.sum())
    in_rays = int((rid < n_rays).sum())
    nid = torch.where(valid, node, torch.full_like(node, N)).long()
    src = torch.where(valid & (w > 0.01), 512, -1).to(torch.int32)
    base = torch.full((N + 1,), -1, dtype=torch.int32, device=node.device)
    r = exact_case("K14 votes", f"{label}: n={n}, {n_valid} valid rows, R={n_rays}, N={N}",
                   lambda: dv.compute_occupancy_adders(*args),
                   lambda: dv.compute_occupancy_adders_plain(*args),
                   (n_rays + 1) * 4 + in_rays * 4 + n_valid * 8 + N * 16,
                   lambda: base.scatter_reduce(0, nid, src, "amax", include_self=True),
                   "scatter_reduce amax")
    computed = exact_case("K14 votes", f"{label}, offsets computed by the wrapper",
                          lambda: dv.compute_occupancy_adders(*args[:6]),
                          lambda: dv.compute_occupancy_adders_plain(*args[:6]),
                          (n_rays + 1) * 4 + n * 4 + in_rays * 4 + n_valid * 8 + N * 16)
    return dict(r, n=n, valid=n_valid, N=N, offsets_computed_ms=computed["ms"],
                max_abs_err=max(r["max_abs_err"], computed["max_abs_err"]))


def fold_case(args: tuple, label: str) -> dict:
    """K14's fold on (tree, votes). Bound: the four votes and the four
    counters read once, four counters written: 48 bytes a node."""
    from f2nerf_torch.sampler import device as dv
    tree, occ = args
    N = tree.trans_idx.shape[0]

    def stats(t):
        return {k: getattr(t, k) for k in OCC_FIELDS}
    r = exact_case("K14 fold", f"{label}: N={N}", lambda: stats(dv.apply_occupancy_adders(*args)),
                   lambda: stats(dv.apply_occupancy_adders_plain(*args)), N * 48)
    return dict(r, N=N)


def dense_uniform_args(tr, gen, R: int = 2048, max_s: int = 512, cap: int = 393216) -> tuple:
    """compact_a_warp's input at the slice's shape on the trainer's tree:
    n_s uniform in [0, 384) (mean 192: the total near cap), every 97th ray
    empty, each sample at a valid leaf or, a tenth of them, at a node whose
    leaf row is -1; t within the root; uniform rays."""
    dev = torch.device(DEV)
    ti = tr.tree.trans_idx
    leaves, dead = torch.nonzero(ti >= 0).flatten(), torch.nonzero(ti < 0).flatten()
    n_s = torch.randint(0, 384, (R,), generator=gen, device=dev, dtype=torch.int32)
    n_s[::97] = 0
    live = torch.arange(max_s, device=dev)[None, :] < n_s[:, None]

    def pick(pool):
        return pool[torch.randint(0, pool.numel(), (R, max_s), generator=gen, device=dev)]
    node = torch.where(torch.rand((R, max_s), generator=gen, device=dev) < 0.1,
                       pick(dead), pick(leaves)).to(torch.int32)
    zero = torch.zeros((R, max_s), device=dev)
    side = float(tr.tree_host.side[0])
    out_t = torch.where(live, torch.rand((R, max_s), generator=gen, device=dev) * side, zero)
    out_dt = torch.where(live, torch.rand((R, max_s), generator=gen, device=dev) * 0.01, zero)
    out_node = torch.where(live, node, torch.full_like(node, -1))
    o, d = uniform_rays(gen, R)
    return (tr.tree, n_s, out_t, out_dt, out_node, o, d, cap)


def degenerate_warp_args() -> tuple:
    """K12 on a one-leaf tree whose warp divides by zero: projection 0 is
    x / z, the others x / 1, and every axis is projection 0; rays and edge
    samples at z = 0 warp to +-inf (x != 0) and NaN (x = 0). Returns
    (compact_a_warp's args, with empty rays and padding; sample_edges'
    args)."""
    from f2nerf_torch.sampler import device as dv
    from f2nerf_torch.sampler.octree import OctreeHost
    w2xz = np.zeros((1, 12, 2, 4), np.float32)
    w2xz[0, :, 0, :3] = [1.0, 0.0, 0.0]
    w2xz[0, 0, 1, :3] = [0.0, 0.0, 1.0]
    w2xz[0, 1:, 1, 3] = 1.0
    weight = np.zeros((1, 3, 12), np.float32)
    weight[0, :, 0] = 1.0
    f32 = np.float32
    host = OctreeHost(
        center=np.zeros((1, 3), f32), side=np.array([2.0], f32),
        parent=np.array([-1], np.int32), childs=np.full((1, 8), -1, np.int32),
        is_leaf=np.array([True]), trans_idx=np.array([0], np.int32),
        weight_stats=np.full(1, 1000, np.int32), alpha_stats=np.full(1, 1000, np.int32),
        visit_cnt=np.zeros(1, np.int32), w2xz=w2xz, weight=weight,
        t_center=np.zeros((1, 3), f32), t_dis=np.array([1.0], f32),
        edge_t=np.zeros((1, 2), np.int32), edge_center=np.zeros((1, 3), f32),
        edge_dir0=np.array([[1.0, 0.0, 0.0]], f32), edge_dir1=np.array([[0.0, 1.0, 0.0]], f32),
        side_len=2.0)
    tree = dv.to_device_tree(host, 8, 8, 8, device=DEV)
    dev = torch.device(DEV)
    R, max_s = 6, 8
    n_s = torch.tensor([3, 0, 8, 1, 2, 0], dtype=torch.int32, device=dev)
    out_t = torch.zeros((R, max_s), device=dev)
    out_t[2, 1:] = torch.linspace(0.1, 0.7, 7, device=dev)
    o = torch.tensor([[0.0, 0.0, 0.0], [0.3, 0.0, 0.0], [0.2, 0.1, 0.0], [0.0, 0.5, 0.0],
                      [-0.4, 0.0, 0.0], [0.1, 0.1, 0.1]], device=dev)
    d = torch.tensor([[1.0, 0.0, 0.0]] * R, device=dev)
    a_args = (tree, n_s, out_t, torch.full((R, max_s), 0.01, device=dev),
              torch.zeros((R, max_s), dtype=torch.int32, device=dev), o, d, 32)
    coord = torch.rand((64, 2), generator=torch.Generator(device=dev).manual_seed(1),
                       device=dev) * 2.0 - 1.0
    coord[0] = 0.0
    return a_args, (tree, torch.zeros((64,), dtype=torch.int32, device=dev), coord)


def keep_uniform_args(gen, n: int = 393216, cap: int = 262144, R: int = 2048,
                      mode: str = "uniform") -> tuple:
    """K13's input at the slice's uniform shape: A's fields over n rows
    (R rays of U[0, 2 n / R) rows each, sorted, padding past the last),
    each row kept with probability one half. ``mode``: 'nopad' (every row
    in a ray: no padding row in A), 'gaps' (every third ray has rows, the
    others none), 'one_ray' (R = 1: every valid row in ray 0)."""
    from f2nerf_torch.render import renderer as rd
    dev = torch.device(DEV)
    if mode == "one_ray":
        R = 1
    counts = torch.randint(0, 2 * n // R, (R,), generator=gen, device=dev)
    if mode == "nopad":
        counts = torch.full((R,), -(-n // R), device=dev)
    elif mode == "gaps":
        counts = torch.where(torch.arange(R, device=dev) % 3 == 0, 3 * counts, 0)
    elif mode == "one_ray":
        counts = torch.full((1,), n // 2, device=dev)
    rid = torch.repeat_interleave(torch.arange(R, device=dev), counts)[:n]
    rid = torch.cat([rid, torch.full((n - rid.numel(),), R, device=dev)]).to(torch.int32)
    fields = {k: (torch.rand((n,) if c == 1 else (n, c), generator=gen, device=dev) if
                  dt == torch.float32 else
                  torch.randint(0, 1 << 16, (n,), generator=gen, device=dev, dtype=dt))
              for k, dt, c in rd.KEEP_FIELDS}
    keep = (torch.rand((n,), generator=gen, device=dev) < 0.5) & (rid < R)
    return keep, cap, fields, rid, R


def votes_uniform_args(tr, seed: int, special: bool, R: int = 2048, per: int = 192,
                       cap: int = 393216) -> tuple:
    """The votes' input at the slice's shape on the trainer's tree: ray r
    has U[0, 2 per) rows (a tenth of the rays none), in runs of 1-8 rows
    at one of 4,096 of the tree's leaves (so a node comes back within a ray
    and across rays), a twentieth of the rows at node -1, padding to cap;
    weights U[0, 0.05), alphas U[0, 0.1). ``special``: of each, 1% NaN, 1%
    +inf, 1% -inf and 3% -0.0, and 16 rays all -0.0."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(0, 2 * per, R)
    counts[rng.rand(R) < 0.1] = 0
    rid = np.repeat(np.arange(R), counts)[:cap]
    n = len(rid)
    leaves = np.nonzero(tr.tree_host.trans_idx >= 0)[0]
    pool = rng.choice(leaves, 4096)
    node = np.repeat(rng.choice(pool, n), rng.randint(1, 9, n))[:n]
    node[rng.rand(n) < 0.05] = -1
    rid = np.concatenate([rid, np.full(cap - n, R)]).astype(np.int32)
    node = np.concatenate([node, np.full(cap - n, -1)]).astype(np.int32)
    w = rng.uniform(0, 0.05, cap).astype(np.float32)
    a = rng.uniform(0, 0.1, cap).astype(np.float32)
    if special:
        for x in (w, a):
            u = rng.rand(cap)
            x[u < 0.01] = np.nan
            x[(u >= 0.01) & (u < 0.02)] = np.inf
            x[(u >= 0.02) & (u < 0.03)] = -np.inf
            x[(u >= 0.03) & (u < 0.06)] = -0.0
            x[np.isin(rid, rng.choice(R, 16))] = -0.0
    return (tr.tree, *(torch.from_numpy(x).to(DEV) for x in (node, rid, w, a)), R)


def warp_compact_occupancy_rows(calls: dict, tr) -> list[dict]:
    """K12 (compact_a_warp, sample_edges), K13 (compact_keep) and K14 (the
    votes and the fold), each at one slice step's own inputs (spied; the
    row's ms, plain_ms, bound_ms and library_ms) and beside them:
      compact_a_warp — uniform at the slice's shape (``dense_uniform_args``:
          empty rays, nodes whose leaf row is -1), the step's inputs at half
          the total's capacity (overflow), the degenerate warp;
      sample_edges — the degenerate warp's edge samples;
      compact_keep — uniform at the slice's shape (``keep_uniform_args``),
          the step's flags at half the kept rows' capacity (overflow), at
          exactly their count (B full) and with nothing kept, A with no
          padding row, rays without rows, one ray (B's segments held too);
      votes — uniform at the slice's shape with finite weights and with
          NaN, +-inf and -0.0 weights (``votes_uniform_args``), each with
          the offsets given and computed (``votes_case``);
      fold — the uniform votes folded into the step's tree."""
    from f2nerf_torch.sampler import device as dv
    gen = torch.Generator(device=DEV).manual_seed(12)
    (a_args,), (e_args,), (k_args,) = (calls["compact_a_warp"], calls["sample_edges"],
                                       calls["compact_keep"])
    (v_args,), (f_args,) = calls["compute_occupancy_adders"], calls["apply_occupancy_adders"]
    deg_a, deg_e = degenerate_warp_args()
    total = int(a_args[1].long().sum())
    kept = int(k_args[0].sum())
    cases = {
        "compact_a_warp": {
            "step": compact_a_case(a_args, "step's own inputs"),
            "uniform": compact_a_case(dense_uniform_args(tr, gen), "uniform"),
            "overflow": compact_a_case(a_args[:-1] + (max(1, total // 2),),
                                       "step's inputs, cap half the total"),
            "degenerate": compact_a_case(deg_a, "degenerate warp")},
        "sample_edges": {
            "step": edges_case(e_args, "step's own draws"),
            "degenerate": edges_case(deg_e, "degenerate warp")},
        "compact_keep": {
            "step": keep_case(k_args, "step's own flags"),
            "uniform": keep_case(keep_uniform_args(gen), "uniform"),
            "overflow": keep_case((k_args[0], max(1, kept // 2)) + k_args[2:],
                                  "step's flags, cap half the kept rows"),
            "none_kept": keep_case((torch.zeros_like(k_args[0]),) + k_args[1:],
                                   "nothing kept"),
            "full": keep_case((k_args[0], max(1, kept)) + k_args[2:],
                              "step's flags, B exactly full"),
            "no_padding": keep_case(keep_uniform_args(gen, mode="nopad"),
                                    "no padding row in A"),
            "rays_without_rows": keep_case(keep_uniform_args(gen, mode="gaps"),
                                           "two rays in three without rows"),
            "one_ray": keep_case(keep_uniform_args(gen, mode="one_ray"), "n_rays = 1")}}
    uni = votes_uniform_args(tr, 14, False)
    cases["compute_occupancy_adders"] = {
        "step": votes_case(v_args, "step's own buffer"),
        "uniform": votes_case(uni, "uniform"),
        "special": votes_case(votes_uniform_args(tr, 15, True), "NaN, +-inf and -0.0 weights")}
    cases["apply_occupancy_adders"] = {
        "step": fold_case(f_args, "step's own votes"),
        "uniform": fold_case((f_args[0], dv.compute_occupancy_adders(*uni)), "uniform votes")}
    meta = {"compact_a_warp": ("f2nerf_torch/csrc/warp.cu", "f2nerf_tpu/render/renderer.py:96",
                               NO_LIBRARY_WARP),
            "sample_edges": ("f2nerf_torch/csrc/warp.cu", "f2nerf_tpu/sampler/device.py:649",
                             NO_LIBRARY_WARP),
            "compact_keep": ("f2nerf_torch/csrc/compact.cu", "f2nerf_tpu/render/renderer.py:72",
                             NO_LIBRARY_KEEP),
            "compute_occupancy_adders": ("f2nerf_torch/csrc/occupancy.cu",
                                         "f2nerf_tpu/sampler/device.py:667", LIBRARY_VOTES),
            "apply_occupancy_adders": ("f2nerf_torch/csrc/occupancy.cu",
                                       "f2nerf_tpu/sampler/device.py:719", NO_LIBRARY_FOLD)}
    rows = []
    for name, cs in cases.items():
        source, replaces, library = meta[name]
        step = cs["step"]
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         library=library, bound_by="bytes",
                         **{k: step[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
                         max_abs_err=max(r["max_abs_err"] for r in cs.values()),
                         **{f"{c}_{k}": v for c, r in cs.items() for k, v in r.items()}))
    return rows


def rays_rows(calls: dict, tr) -> list[dict]:
    """K15 at one slice step's own draws and tables (the step's
    ``sample_rays`` call, spied, against ``sample_rays_plain``: the row's
    ms, plain_ms and bound_ms) and beside it in its camera form over one
    of the scene's whole image grids (``pixel_to_ray`` on ``camera_rays``'
    grid against ``pixel_to_ray_plain``), each bit for bit and launched twice
    (``exact_case``). Bound: bytes, the draws in, RAYS_RAY_BYTES a ray and
    each camera's rows once; the image: its f32 pixels in, the rays out,
    one camera's rows."""
    from f2nerf_torch.core import camera
    from f2nerf_torch.data import dataset as ds
    (args,) = calls["sample_rays"]
    data, pick = args[0], args[1]
    n = pick.shape[0]
    cams = int(torch.unique(data["train_ids"][pick.long()]).numel())
    nbytes = n * (3 * pick.element_size() + RAYS_RAY_BYTES) + cams * RAYS_TRAIN_CAM_BYTES
    step = exact_case("K15 sample_rays", f"slice step's own draws: n={n} "
                      f"{str(pick.dtype)[6:]}, {cams} cameras",
                      lambda: ds.sample_rays(*args), lambda: ds.sample_rays_plain(*args), nbytes)
    h, w = tr.dataset.height, tr.dataset.width
    ii, jj = ds._pixel_grid(h, w, 1, pick.device)
    cam = [data[k][0] for k in ("poses", "intri", "dist")]
    image = exact_case("K15 pixel_to_ray", f"camera 0's whole {h}x{w} image",
                       lambda: camera.pixel_to_ray(*cam, ii, jj),
                       lambda: camera.pixel_to_ray_plain(*cam, ii, jj),
                       h * w * (8 + 24) + RAYS_CAM_BYTES)
    cases = {"step": step, "image": image}
    return [dict(name="rays_kernel", route="cuda", source="f2nerf_torch/csrc/rays.cu",
                 replaces="f2nerf_tpu/data/dataset.py:154", library=NO_LIBRARY_RAYS,
                 bound_by="bytes", **{k: step[k] for k in ("ms", "plain_ms", "bound_ms",
                                                            "library_ms")},
                 max_abs_err=max(r["max_abs_err"] for r in cases.values()),
                 **{f"{c}_{k}": v for c, r in cases.items() for k, v in r.items()})]


def uniform_rays(gen, R: int, lo: float = -1.0, hi: float = 1.0):
    """R rays on the card with origins uniform in [lo, hi]^3 and uniform
    directions."""
    from f2nerf_torch.sampler import device as dv
    dev = torch.device(DEV)
    o = torch.rand((R, 3), generator=gen, device=dev) * (hi - lo) + lo
    d = torch.randn((R, 3), generator=gen, device=dev)
    return o, d / dv.norm3(d)[:, None]


def tree_near_cap(host, over: bool):
    """A copy of the host tree split (proc_octree, no compaction) until its
    node count lies just under K8's shared-memory cap (over=False: staged
    in shared memory) or just over it (read from global memory): every
    valid leaf split 8 ways while that stays under the cap, then the first
    k valid leaves, marked as visited."""
    from f2nerf_torch.sampler import device as dv
    from f2nerf_torch.sampler import octree as oc
    cap = dv.TRAVERSE_SMEM_NODES
    base = oc.proc_octree(host, False, False, False)      # the nodes a split keeps

    def valid_leaves(t):
        return np.nonzero(t.is_leaf & (t.trans_idx >= 0))[0]
    while base.n_nodes + 8 * len(valid_leaves(base)) <= cap:
        base = oc.proc_octree(base, False, True, True)
    k = (cap - base.n_nodes) // 8 + (1 if over else 0)
    base.visit_cnt[valid_leaves(base)[:k]] = 5
    return oc.proc_octree(base, False, True, False)


def traverse_extra_cases(tr, near: float) -> dict:
    """K8 on the trainer's tree beyond the step's inputs:
      uniform  — TRAV_UNIFORM_RAYS rays from U[-1, 1]^3, hit cap 64;
      distant  — 512 rays from ~4000 units away, each aimed at a random
                 valid leaf's center (ulp(t) exceeds a leaf's eps:
                 tests/test_torch_sampler.py's distant-origin case);
      grazing  — a copy of the tree with 60% of its valid leaves culled,
                 rays nearly parallel to a face of a culled leaf, 600
                 iterations at most (that file's grazing case);
      under_cap, over_cap — the uniform rays on the tree split to just
                 under and just over K8's shared-memory cap
                 (``tree_near_cap``): the two memory paths."""
    from f2nerf_torch.sampler import device as dv
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(8)
    out = {}
    R = TRAV_UNIFORM_RAYS
    full = torch.full((R,), 1e8, device=dev)
    o, d = uniform_rays(gen, R)
    out["uniform"] = traverse_case((tr.tree, o, d, torch.full((R,), near, device=dev),
                                    full, 64), f"{R} uniform rays, hit cap 64")
    host = tr.tree_host
    s0 = float(host.side[0])
    rng = np.random.RandomState(7)
    valid = np.nonzero((host.trans_idx >= 0) & host.is_leaf)[0]
    aim = host.center[rng.choice(valid, 512)].astype(np.float64)
    dd = rng.randn(512, 3)
    dd /= np.linalg.norm(dd, axis=-1, keepdims=True)
    o = torch.tensor(aim - 4000.0 * dd, dtype=torch.float32, device=dev)
    d = torch.tensor(dd, dtype=torch.float32, device=dev)
    out["distant"] = traverse_case((tr.tree, o, d, torch.full((512,), near, device=dev),
                                    torch.full((512,), 1e8, device=dev), 64),
                                   "512 rays from 4000 units away")
    culled = copy.deepcopy(host)
    kill = rng.choice(valid, size=int(0.6 * len(valid)), replace=False)
    culled.trans_idx[kill] = -1
    os_, ds_ = [], []
    for u in kill[:256]:
        c, s = culled.center[u].astype(np.float64), float(culled.side[u])
        for dz in (1e-6, 1e-5, 1e-4, -1e-6, -1e-5):
            v = np.array([1.0, 0.0, dz]) / np.sqrt(1.0 + dz * dz)
            face = c[2] + s / 2 if dz > 0 else c[2] - s / 2
            os_.append([c[0] - 5.0 * s0, c[1], face - np.sign(dz) * 3e-6 - v[2] * 5.0 * s0])
            ds_.append(v)
    n = len(os_)
    ctree = dv.to_device_tree(culled, tr.max_nodes, tr.max_trans, tr.max_edges, device=DEV)
    out["grazing"] = traverse_case(
        (ctree, torch.tensor(np.asarray(os_), dtype=torch.float32, device=dev),
         torch.tensor(np.asarray(ds_), dtype=torch.float32, device=dev),
         torch.full((n,), near, device=dev),
         torch.full((n,), 1e8, device=dev), 64, 600),
        f"{n} grazing rays, 60% of the leaves culled, 600 iterations at most")
    o, d = uniform_rays(gen, R)
    for key, over in (("under_cap", False), ("over_cap", True)):
        host_k = tree_near_cap(host, over)
        tree_k = dv.to_device_tree(host_k, tr.max_nodes, tr.max_trans, tr.max_edges,
                                   device=DEV)
        if (dv.traverse_smem_nodes(tree_k) > 0) == over:
            raise AssertionError(f"{key}: {host_k.n_nodes} nodes on the wrong side of "
                                 f"the cap {dv.TRAVERSE_SMEM_NODES}")
        out[key] = traverse_case((tree_k, o, d, torch.full((R,), near, device=dev), full, 64),
                                 f"{R} uniform rays, {host_k.n_nodes} nodes "
                                 f"({key.replace('_', ' ')})")
    return out


def degenerate_march_args() -> tuple:
    """tests/test_torch_sampler.py:244's case on the card: a one-leaf tree
    whose warp is degenerate (b == 0) at the camera origin, the hit
    slots past n_hits evaluating it; all-ones jitter."""
    from f2nerf_torch.sampler import device as dv
    from f2nerf_torch.sampler.octree import OctreeHost
    w2xz = np.zeros((1, 12, 2, 4), np.float32)
    w2xz[0, :, 0, :3] = [1.0, 0.0, 0.0]
    w2xz[0, :, 1, :3] = [0.0, 0.0, 1.0]
    weight = np.zeros((1, 3, 12), np.float32)
    weight[0, 0, 0] = weight[0, 1, 1] = weight[0, 2, 2] = 1.0
    f32 = np.float32
    host = OctreeHost(
        center=np.array([[0.0, 0.0, -2.0]], f32), side=np.array([1.0], f32),
        parent=np.array([-1], np.int32), childs=np.full((1, 8), -1, np.int32),
        is_leaf=np.array([True]), trans_idx=np.array([0], np.int32),
        weight_stats=np.full(1, 1000, np.int32), alpha_stats=np.full(1, 1000, np.int32),
        visit_cnt=np.zeros(1, np.int32), w2xz=w2xz, weight=weight,
        t_center=np.array([[0.0, 0.0, -2.0]], f32), t_dis=np.array([1.0], f32),
        edge_t=np.zeros((0, 2), np.int32), edge_center=np.zeros((0, 3), f32),
        edge_dir0=np.zeros((0, 3), f32), edge_dir1=np.zeros((0, 3), f32), side_len=1.0)
    tree = dv.to_device_tree(host, 8, 8, 8, device=DEV)
    dev = torch.device(DEV)
    d = np.array([[-0.05, 0.0, -1.0]], f32)
    o = torch.tensor([[0.3, 0.0, 0.0]], device=dev)
    d = torch.tensor(d / np.linalg.norm(d), device=dev)
    hits = dv.traverse(tree, o, d, torch.tensor([0.01], device=dev),
                       torch.tensor([1e8], device=dev), 4)[:4]
    return (tree, o, d, *hits, torch.ones((1, 64), device=dev),
            torch.ones((), device=dev), 1.0 / 16, False, 64)


def march_parallel_extra_cases(step_args: tuple, trav_args: tuple) -> dict:
    """K9 beyond the step's inputs: the step's hits with scale_by_dis
    flipped, with eval's all-ones jitter, the degenerate-warp case, and the
    step's rays traversed again at hit caps 16 (below a warp) and 40 (not a
    multiple of 32)."""
    from f2nerf_torch.sampler import device as dv
    a = list(step_args)
    flipped = tuple(a[:10] + [not a[10]] + a[11:])
    ones = tuple(a[:7] + [torch.ones_like(a[7])] + a[8:])
    out = {"flipped": march_parallel_case(flipped, f"step's hits, scale_by_dis {not a[10]}"),
           "ones": march_parallel_case(ones, "step's hits, all-ones jitter (eval)"),
           "degenerate": march_parallel_case(degenerate_march_args(),
                                             "degenerate warp past n_hits")}
    for H in (16, 40):
        hits = dv.traverse(*trav_args[:5], H)[:4]
        out[f"h{H}"] = march_parallel_case(tuple(a[:3] + list(hits) + a[7:]),
                                           f"step's rays at hit cap {H}")
    return out


def phase_kernels(baseline: str | None = None) -> list[dict]:
    from f2nerf_torch.fields import hash_block as hb
    from f2nerf_torch.fields.hash_encoding import _random_primes
    from f2nerf_torch.ops import fused_adam as fa
    from f2nerf_torch.train.trainer import ADAM_KW

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    # ---- K1 fused Adam over every leaf
    t_step = 3
    scal = torch.tensor([1e-2, 1.0 / (1 - 0.9 ** t_step), 1.0 / (1 - 0.99 ** t_step)],
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
    # torch._fused_adam_ (the op behind torch.optim.Adam(fused=True)) is the
    # yardstick: the same update, with the bias corrections rounded elsewhere
    # (sqrt(v)/sqrt(1-b2^t) against sqrt(v*c2)); the port never calls it
    pool = {k: v for k, v in _adam_case(dev, gen)[0].items() if k != "wd"}
    lib_in = {k: v.clone() for k, v in pool.items()}
    step = torch.full((), float(t_step), dtype=torch.float32, device=dev)
    lr_t, found_inf = scal[0].clone(), (~yes).to(torch.float32)

    def library():
        torch._fused_adam_([lib_in["p"]], [lib_in["g"]], [lib_in["m"]], [lib_in["v"]],
                           [], [step], lr=lr_t, beta1=ADAM_KW["b1"], beta2=ADAM_KW["b2"],
                           weight_decay=0.0, eps=ADAM_KW["eps"], amsgrad=False,
                           maximize=False, grad_scale=None, found_inf=found_inf)

    ref = {k: v.clone() for k, v in pool.items()}
    library()
    fa.adam_leaf_plain(ref["p"], ref["m"], ref["v"], ref["g"], scal, yes, wd=0.0, **ADAM_KW)
    lib_err = max((lib_in[k] - ref[k]).abs().max().item() for k in "pmv")
    del ref
    t = cuda_time_turns({
        "kernel": lambda: fa.fused_adam(pool["p"], pool["m"], pool["v"], pool["g"],
                                        scal, yes, wd=0.0, **ADAM_KW),
        "library": library})
    plain_ms = cuda_time(lambda: fa.adam_leaf_plain(pool["p"], pool["m"], pool["v"],
                                                    pool["g"], scal, yes, wd=0.0, **ADAM_KW))
    bound1 = bound_ms(7 * 4 * pool["p"].numel())
    log(f"[kernels] K1 fused_adam: max_abs_err {err:.3e} (tol {TOL_ADAM:g}); "
        f"pool [16,16384,128], in turns: kernel {t['kernel']:.4f} ms, "
        f"torch._fused_adam_ {t['library']:.4f} ms (max_abs_err against the plain "
        f"version {lib_err:.3e}), plain {plain_ms:.4f} ms; bound {bound1:.4f} ms "
        f"(reads p, m, v, g, writes p, m, v: 28 B an element; "
        f"{100 * bound1 / t['kernel']:.1f}% of it)")
    if not err <= TOL_ADAM:
        raise AssertionError(f"fused_adam disagrees with its plain version: {err}")
    if not lib_err <= TOL_ADAM:
        raise AssertionError(f"torch._fused_adam_ disagrees with the plain Adam: {lib_err}")
    rows.append(dict(name="fused_adam", route="cuda",
                     source="f2nerf_torch/csrc/fused_adam.cu",
                     replaces="f2nerf_tpu/ops/fused_adam.py:71",
                     max_abs_err=err, ms=t["kernel"], plain_ms=plain_ms,
                     bound_ms=bound1, bound_by="bytes", library_ms=t["library"],
                     library="torch._fused_adam_", library_max_abs_err=lib_err))

    # ---- K2 / K3 at chip_smoke's uniform shape: the slice's cap1 of 393,216
    # samples, uniform points, a uniformly random volume of 431 per sample
    # (the worst case for row locality); the slice's own inputs follow the
    # slice (kernels_at_slice_inputs)
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
    r2 = encode_case((feat, prim, bias, pts, vol, l2t), "uniform")
    rows.append(dict(name="hash_block_fwd", route="cuda",
                     source="f2nerf_torch/csrc/hash_block.cu",
                     replaces="f2nerf_tpu/fields/hash_block.py:153",
                     bound_by="bytes", library_ms=None, library=NO_LIBRARY,
                     **{f"uniform_{k}": v for k, v in r2.items()},
                     **{k: r2[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms")}))
    k3_uniform = [(g, prim, bias, pts, vol, l2t, tuple(feat.shape))]
    r3 = scatter_case(k3_uniform, "uniform", library=True)
    skew = [k3_skew_args(gen)]
    r3.update({f"skew_{k}": v for k, v in scatter_case(skew, "skew (2^18 samples in one "
                                                             "row a level)",
                                                             time_plain=False).items()})
    r3.update({f"{case}_{k}": v for case, r in k3_extra_cases(gen).items()
               for k, v in r.items()})
    del skew
    rows.append(dict(name="hash_block_bwd", route="cuda",
                     source="f2nerf_torch/csrc/hash_block.cu",
                     replaces="f2nerf_tpu/fields/hash_block.py:191",
                     bound_by="bytes", library=LIBRARY_K3,
                     **{f"uniform_{k}": v for k, v in r3.items()},
                     **{k: r3[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "library_ms")}))
    del feat, k3_uniform

    # ---- K5 / K6 at the same uniform shape, the Hash3DAnchored pool at
    # full width ([2^19 * 16, 2]); the slice's own inputs follow the
    # variants phase
    pool = torch.randn(((1 << l2t) * 16, 2), generator=gen, device=dev)
    r5 = hash3d_encode_case((pool, prim, bias, pts, vol, l2t), "uniform")
    k6_uniform = (g, prim, bias, pts, vol, l2t, pool.shape[0])
    r6 = hash3d_scatter_case(k6_uniform, "uniform", library=True)
    del pool, g
    torch.cuda.empty_cache()
    r6.update({f"{case}_{k}": v for case, r in k6_extra_cases(gen).items()
               for k, v in r.items()})
    if baseline:
        r6.update({f"{case}_{k}": v for case, r in baseline_k6_turns(baseline, {
            "uniform": k6_uniform, "skew": k6_args(gen, n=1 << 18, skew=True),
            "l2t20": k6_args(gen, l2t=20)}).items() for k, v in r.items()})
    del k6_uniform
    for name, src, r in (("hash_encode_fwd", "f2nerf_tpu/fields/hash_encoding.py:135", r5),
                         ("hash_encode_bwd", "f2nerf_tpu/fields/hash_encoding.py:161", r6)):
        lib = dict(library_ms=None, library=NO_LIBRARY) if r is r5 else \
            dict(library_ms=r["library_ms"], library=LIBRARY_K6)
        rows.append(dict(name=name, route="cuda", source="f2nerf_torch/csrc/hash3d.cu",
                         replaces=src, bound_by="bytes", path="variants (a)", **lib,
                         **{f"uniform_{k}": v for k, v in r.items()},
                         **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms")}))
    torch.cuda.empty_cache()

    # ---- K4 at micro_gather's registered shape (:164): t 2^14, W 128, n 2^20;
    # the slice's cached-B shape follows the slice (its cap1/cap2)
    t, n4 = 1 << 14, 1 << 20
    table = torch.randn((t, 128), generator=gen, device=dev)
    idx = torch.randint(0, t, (n4,), generator=gen, device=dev).to(torch.int32)
    r4 = gather_check(table, idx, "micro_gather shape")
    rows.append(dict(name="row_gather", route="cuda",
                     source="f2nerf_torch/csrc/row_gather.cu",
                     replaces="benchmarks/micro_gather.py:102", bound_by="bytes",
                     library="torch.index_select",
                     **{f"micro_gather_{k}": v for k, v in r4.items()}, **r4))
    del table, idx

    # ---- K10 / K11 at SEG_RAYS uniform rays; the slice's own calls follow
    # the slice
    rows += segment_uniform_rows(gen)
    return rows


def capture_step_inputs(tr) -> dict:
    """One more slice step with K2's, K3's and K4's wrappers spied on (as
    fields/hash_block.py calls them), K8's, K9's, the offsets launch's,
    K12's, K13's and K14's (as render/renderer.py and train/trainer.py call
    them), K10's and K11's (as ops/segment.py calls them) and
    ``sample_rays``, K15's training form (as train/trainer.py calls it):
    the arguments of every call, in order (``capture_calls``)."""
    from f2nerf_torch.data import dataset as ds
    from f2nerf_torch.fields import hash_block as hb
    from f2nerf_torch.ops import segment as sg
    from f2nerf_torch.sampler import device as dv
    from f2nerf_torch.render import renderer
    return capture_calls(tr, {"hash_block_fwd": hb, "hash_block_bwd": hb, "row_gather": hb,
                              "traverse": dv, "ray_march_parallel": dv,
                              "segment_reduce": sg, "segment_scan": sg,
                              "ray_offsets": renderer, "compact_a_warp": renderer,
                              "compact_keep": renderer, "sample_edges": dv,
                              "compute_occupancy_adders": dv, "apply_occupancy_adders": dv,
                              "first_flags_from_ray_id": renderer, "sample_rays": ds})


def kernels_at_slice_inputs(rows: list[dict], tr, cap1: int, cap2: int,
                            launches: dict) -> None:
    """The kernels at the slice's own inputs, which become the ``ms``,
    ``plain_ms`` and ``bound_ms`` of their rows (the earlier shapes keep
    theirs under ``uniform_``/``micro_gather_``):
      K2: A's points and volumes at cap1 (the prefilter's encode) from one
          more step of the slice's Trainer;
      K3: that step's table-gradient scatter: B at cap2 plus the edge
          samples, with the step's own gradient (``scatter_case``: bit
          for bit its plain version and a second run, the library call;
          the active pairs a row by level, ``k3_rows_histogram``);
      K4: that step's [cap1, 32] cache of A's encodings and its cap2 int64
          indices (increasing; the padding rows all at cap1 - 1). Also at
          the earlier stand-in for them (``standin_`` keys): a random
          [cap1, 32] cache and cap2 distinct increasing indices;
      K8: that step's rays and tree (a new row; also ``traverse_extra_cases``
          under their names);
      K9: that step's hits and jitter (a new row; also
          ``march_parallel_extra_cases`` under their names);
      K10/K11: every call of that step, forward and backward
          (``segment_step_cases``: the rows' times become the sums over
          the step's calls; the uniform case keeps its under ``uniform_``);
      K12/K13/K14: that step's call of each entry point (new rows; also
          their edge cases, ``warp_compact_occupancy_rows``);
      K15: that step's draws and tables, and one whole image in the
          camera form (a new row, ``rays_rows``)."""
    dev = torch.device("cuda")
    calls = capture_step_inputs(tr)
    (trav,), (march,) = calls["traverse"], calls["ray_march_parallel"]
    r8 = traverse_case(trav, "slice step's own rays")
    r8.update({f"{k}_{f}": v for k, r in traverse_extra_cases(tr, float(trav[3][0])).items()
               for f, v in r.items()})
    r9 = march_parallel_case(march, "slice step's own hits")
    r9.update({f"{k}_{f}": v for k, r in march_parallel_extra_cases(march, trav).items()
               for f, v in r.items()})
    del trav, march
    rows.append(dict(name="traverse", route="cuda", source="f2nerf_torch/csrc/traverse.cu",
                     replaces="f2nerf_tpu/sampler/device.py:231", library_ms=None,
                     library=NO_LIBRARY_TRAVERSE, **{f"slice_{k}": v for k, v in r8.items()},
                     **{k: r8[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by")}))
    rows.append(dict(name="ray_march_parallel", route="cuda",
                     source="f2nerf_torch/csrc/march_parallel.cu",
                     replaces="f2nerf_tpu/sampler/device.py:547", library_ms=None,
                     library=NO_LIBRARY_MARCH_PARALLEL,
                     **{f"slice_{k}": v for k, v in r9.items()},
                     **{k: r9[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by")}))
    fwd = max(calls["hash_block_fwd"], key=lambda a: a[3].shape[0])
    r2 = encode_case(fwd, f"slice A at cap1 {fwd[3].shape[0]}")
    r3 = scatter_case(calls["hash_block_bwd"], f"slice B at cap2 {cap2} + edges",
                      library=True)
    hist = k3_rows_histogram(calls["hash_block_bwd"])
    log("[kernels] K3's active pairs a row at the slice step's own inputs, by level "
        "(pairs, rows touched, median, p99, max): " + "; ".join(
            f"{l}: {h['pairs']}, {h['rows']}, {h['median']:g}, {h['p99']:g}, {h['max']}"
            for l, h in hist.items()))
    r3["rows_histogram"] = hist
    (cache, idx), = calls["row_gather"]
    r4 = gather_check(cache, idx, f"slice's own inputs (cap1 {cache.shape[0]}, "
                                  f"cap2 {idx.shape[0]})")
    # the renderer takes first flags from torch ops for A only (B's from K13)
    firsts = [tuple(a[0].shape) for a in calls["first_flags_from_ray_id"]]
    a_rows = tuple(calls["compact_keep"][0][3].shape)
    log(f"[kernels] first_flags_from_ray_id in one slice step: {firsts} (A's {a_rows})")
    if firsts != [a_rows]:
        raise AssertionError(f"first_flags_from_ray_id ran on {firsts}, expected A's alone")
    seg = segment_step_cases(calls)
    rows += warp_compact_occupancy_rows(calls, tr)
    rows += rays_rows(calls, tr)
    del calls, fwd, cache, idx

    gen = torch.Generator(device=dev).manual_seed(4)
    cache = torch.randn((cap1, 32), generator=gen, device=dev)
    idx = torch.randperm(cap1, generator=gen, device=dev)[:cap2].sort().values
    r4.update({f"standin_{k}": v for k, v in gather_check(
        cache, idx, f"stand-in slice shape (cap1 {cap1}, cap2 {cap2})").items()})
    at_slice = {"hash_block_fwd": r2, "hash_block_bwd": r3, "row_gather": r4, **seg}
    for r in rows:
        new = at_slice.get(r["name"])
        if new is not None:
            r.update({k: new[k] for k in ("ms", "plain_ms", "bound_ms")},
                     max_abs_err=max(r["max_abs_err"], new["max_abs_err"]),
                     **{f"slice_{k}": v for k, v in new.items()})
            if "library_ms" in new:
                r["library_ms"] = new["library_ms"]
        r["launches_per_step"] = launches.get(r["name"], 0) / N_STEPS


def _compose(extra=(), config: str = "wanjinyou"):
    from f2nerf_torch.utils.config import compose
    return compose(os.path.join(REPO, "confs"), config,
                   ["+train.fused_adam=true", *extra])


def slice_steps(tmp: str, count: bool = True):
    """The slice's Trainer and its N_STEPS timed steps (steps TIME_FROM on
    timed): returns (trainer, launches or None, the last metrics, the
    params before the steps). ``count``: the launch counts are set to 0
    just before the steps and read just after (off when this script
    times an older tree's package, whose wrappers differ)."""
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

    if count:
        reset_counts()
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
    launches = read_counts() if count else None
    n_timed = N_STEPS - TIME_FROM + 1
    peak = torch.cuda.max_memory_allocated()
    log(f"[slice] steps {TIME_FROM}-{N_STEPS}: {n_timed / dt:.3f} steps/s, "
        f"{rays / dt:.1f} rays/s; peak memory {peak / 2**30:.3f} GiB; launches {launches}")
    return tr, launches, m, p0


def phase_slice(tmp: str) -> tuple[dict, object, tuple[int, int]]:
    from f2nerf_torch.utils.tree import named_leaves

    tr, launches, m, p0 = slice_steps(tmp)
    moved = max((v.detach() - p0[k]).abs().max().item()
                for k, v in named_leaves(tr.params))
    log(f"[slice] max |param change| {moved:.3e}; K10 / offsets / K11 launches a step "
        f"{launches['segment_reduce'] / N_STEPS:g} / {launches['ray_offsets'] / N_STEPS:g} / "
        f"{launches['segment_scan'] / N_STEPS:g}; K12 (A, edges) / K13 / K14 (votes, fold) "
        f"{launches['compact_a_warp'] / N_STEPS:g}, {launches['sample_edges'] / N_STEPS:g} / "
        f"{launches['compact_keep'] / N_STEPS:g} / "
        f"{launches['compute_occupancy_adders'] / N_STEPS:g}, "
        f"{launches['apply_occupancy_adders'] / N_STEPS:g}; K15 "
        f"{launches['rays_kernel'] / N_STEPS:g}")
    if not moved > 0:
        raise AssertionError("params did not move")
    # one table-gradient scatter a step: the grad pass's B and edge samples
    # share one K3 launch; one traversal and one march a step; no offsets
    # launch (K12 writes A's offsets, K13 B's segments), K10 five times (the
    # composite's sums, weight_var's two, the backwards of the appearance
    # gather and of weight_var's mean gather), K11 three times (the
    # prefilter's and the composite's scans, the composite's backward);
    # K12's A side and edge samples, K13, K14's votes and fold and K15 (the
    # step's rays) once each
    check_counts("the slice", launches, {
        "fused_adam": N_STEPS * len(p0), "hash_block_fwd": N_STEPS},
        exact={"hash_block_bwd": N_STEPS, "row_gather": N_STEPS, "hash_encode_fwd": 0,
               "hash_encode_bwd": 0, "ray_march": 0, "traverse": N_STEPS,
               "ray_march_parallel": N_STEPS, "ray_offsets": 0,
               "segment_reduce": 5 * N_STEPS, "segment_scan": 3 * N_STEPS,
               **{k: N_STEPS for k in warp_need(1)}})
    sync_counts(tr)
    step_twice(tr)
    return launches, tr, (m["cap1"], m["cap2"])


def step_twice(tr, where: str = "slice") -> None:
    """One step of the trainer's config run twice from one state
    (``trainer_snapshot``) with one set of draws, torch's deterministic
    algorithms off, as every run of the port is: every gradient leaf,
    parameter, Adam state leaf and occupancy counter must be bit for bit
    (K3 and K6 sum in a fixed order, so no float sum of the step depends on
    timing). The trainer is left as it was."""
    from f2nerf_torch.utils.tree import named_leaves

    tr.freeze_controller()                 # one bucket and one set of caps for both
    snap = trainer_snapshot(tr)
    n_rays = tr.cur_batch_size()
    _, st = tr._get_step(n_rays)
    draws = tr.draw(st, n_rays)
    runs = []
    for _ in range(2):
        restore_snapshot(tr, snap)
        tr.train_one(draws=draws)
        torch.cuda.synchronize()
        runs.append({
            **{f"grad {k}": v.grad.detach().clone() for k, v in named_leaves(tr.params)
               if v.grad is not None},
            **{f"param {k}": v.detach().clone() for k, v in named_leaves(tr.params)},
            **{f"adam {k}": v.clone() for k, v in named_leaves(tr.opt_state)},
            **{f"occupancy {k}": getattr(tr.tree, k).clone() for k in OCC_FIELDS}})
    restore_snapshot(tr, snap)
    tr.freeze_controller(False)
    a, b = runs
    differ = {k: int((a[k] != b[k]).sum()) if a[k].dtype != torch.float32 else
              int((a[k].view(torch.int32) != b[k].view(torch.int32)).sum())
              for k in a if not bits_equal(a[k], b[k])}
    log(f"[{where}] one step twice from iteration {snap['iter_step']}, n_rays {n_rays}, torch "
        f"deterministic off: {len(a)} leaves (gradients, params, Adam state, occupancy "
        f"counters), {len(differ)} differ {differ}")
    if differ or a.keys() != b.keys():
        raise AssertionError(f"one step run twice from one state differs: {differ}")


class SpanSyncCounter:
    """While active: torch's synchronizing-call warnings (under
    ``torch.cuda.set_sync_debug_mode("warn")``), counted by the innermost
    span open on the raising thread when each was raised
    (``f2nerf_torch.utils.spans.current``, with the span table collected
    meanwhile). Wraps ``warnings.showwarning``; other warnings show as
    always."""

    def __enter__(self):
        import collections
        import warnings
        from f2nerf_torch.utils import spans
        self.counts = collections.Counter()
        self.was = spans.collect(True)

        def show(message, category, *a, **kw):
            if "synchroniz" in str(message):
                self.counts[spans.current() or "(outside the step's spans)"] += 1
            else:
                self.real_show(message, category, *a, **kw)

        self.warn = warnings.catch_warnings()
        self.warn.__enter__()
        warnings.simplefilter("always")
        self.real_show, warnings.showwarning = warnings.showwarning, show
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        from f2nerf_torch.utils import spans
        torch.cuda.set_sync_debug_mode("default")
        self.warn.__exit__(*exc)
        spans.collect(self.was)


def sync_counts(tr, k: int = 10) -> dict:
    """One pipelined ``train_many(k)`` chunk under
    ``torch.cuda.set_sync_debug_mode("warn")``: the synchronizing calls a
    step, by span, printed; any in NO_SYNC_SPANS (every span of the render
    and the occupancy fold) fails. The rest (outside those spans) is
    printed, not held."""
    torch.cuda.synchronize()
    it0 = tr.iter_step
    with SpanSyncCounter() as sc:
        tr.train_many(k, sync=False)
    tr._drain(sync=True)
    per_step = {name: n / k for name, n in sorted(sc.counts.items(), key=lambda x: -x[1])}
    log(f"[slice] synchronizing calls a step (set_sync_debug_mode, train_many({k}) "
        f"pipelined, iterations {it0}-{tr.iter_step}): {per_step}; in "
        f"{list(NO_SYNC_SPANS)}: {[sc.counts.get(n, 0) for n in NO_SYNC_SPANS]}")
    if any(sc.counts.get(n, 0) for n in NO_SYNC_SPANS):
        raise AssertionError(f"{NO_SYNC_SPANS} synchronized the host: {dict(sc.counts)}")
    return per_step


def outermost_aten(e) -> bool:
    """An aten op that no other aten op called: one op the host dispatched."""
    if not e.name.startswith("aten::"):
        return False
    p = e.cpu_parent
    while p is not None:
        if p.name.startswith("aten::"):
            return False
        p = p.cpu_parent
    return True


def phase_profile(tr, n_steps: int = 3, where: str = "profile") -> dict:
    """torch.profiler over n_steps more steps: host and device time of each
    step span (f2nerf_torch/utils/spans.py), the device busy share, the
    kernels that take the most device time and a step's launches: the device
    activities (kernels, copies and sets, the hand-written kernels among
    them: what the card runs) and the outermost aten ops (what the host
    dispatches). Device busy counts device-type events
    only (the kernels, copies and sets): torch gives each CPU op the time
    of the kernels it launched, so the earlier count, over every non-span
    entry, counted a kernel launched through an aten op twice; it is
    printed beside the corrected one."""
    from torch.autograd import DeviceType
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

    def is_range(e):
        return e.key.startswith(SPAN_PREFIXES)

    def is_device(e):
        return e.device_type != DeviceType.CPU and not is_range(e)

    old_ms = sum(dev(e, True) for e in avgs if not is_range(e)) / 1e3
    busy_ms = sum(dev(e, True) for e in avgs if is_device(e)) / 1e3
    log(f"[{where}] {n_steps} steps: wall {wall_ms / n_steps:.2f} ms/step, device busy "
        f"{busy_ms / n_steps:.2f} ms/step ({100 * busy_ms / wall_ms:.1f}% of wall; device "
        f"events only); the earlier count (aten ops and their kernels alike) "
        f"{old_ms / n_steps:.2f} ms/step ({100 * old_ms / wall_ms:.1f}%)")
    for e in sorted((e for e in avgs if is_range(e) and e.cpu_time_total > 0),
                    key=lambda e: -e.cpu_time_total):
        log(f"[{where}] span {e.key:24s} host {e.cpu_time_total / 1e3 / n_steps:8.2f} ms/step"
            f"  device {dev(e) / 1e3 / n_steps:8.3f} ms/step  calls {e.count // n_steps}")
    kernels = sorted((e for e in avgs if is_device(e) and dev(e, True) > 0),
                     key=lambda e: -dev(e, True))
    for e in kernels[:16]:
        log(f"[{where}] kernel {e.key[:70]:70s} {dev(e, True) / 1e3 / n_steps:8.3f} ms/step"
            f"  launches {e.count // n_steps}")
    events = prof.events()
    # the spans also appear on the device's timeline (annotations, named
    # as the host's ranges): no work, so not counted
    host = {e.name for e in events if e.device_type == DeviceType.CPU}
    on_dev = [e for e in events if e.device_type != DeviceType.CPU]
    notes = [e for e in on_dev if e.name in host]
    out = dict(wall_ms=wall_ms / n_steps, busy_ms=busy_ms / n_steps,
               busy_share=busy_ms / wall_ms,
               device_launches=(len(on_dev) - len(notes)) / n_steps,
               aten_ops=sum(e.device_type == DeviceType.CPU and outermost_aten(e)
                            for e in events) / n_steps)
    step_notes = sum(e.name.startswith(("step.", "render.")) for e in notes) / n_steps
    log(f"[{where}] launches a step: {out['device_launches']:.1f} device activities "
        f"(kernels, copies, sets; {len(notes) / n_steps:.1f} span annotations left out, "
        f"{step_notes:.1f} of them step.* and render.*), {out['aten_ops']:.1f} outermost "
        f"aten ops")
    return out


def phase_launches(tr) -> dict:
    """A step's launches and the slice's rate, as ``launch_turns`` reads
    them from a process of its own: LAUNCH_TURN_STEPS synced steps timed
    after the slice's steps, then ``phase_profile``'s counts. Prints one
    line ``[launches] {json}``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LAUNCH_TURN_STEPS):
        tr.train_one()
    torch.cuda.synchronize()
    out = dict(steps_per_s=LAUNCH_TURN_STEPS / (time.perf_counter() - t0),
               **phase_profile(tr))
    print("[launches] " + json.dumps(out), flush=True)
    return out


def check_step_launches(out: dict, where: str) -> None:
    """A slice step's launches within STEP_DEVICE_LAUNCHES and
    STEP_ATEN_OPS."""
    if out["device_launches"] > STEP_DEVICE_LAUNCHES or out["aten_ops"] > STEP_ATEN_OPS:
        raise AssertionError(f"{where}: a slice step launched {out['device_launches']} device "
                             f"activities and {out['aten_ops']} outermost aten ops, more than "
                             f"{STEP_DEVICE_LAUNCHES} / {STEP_ATEN_OPS}")


def launch_turns(root: str) -> dict:
    """--baseline ROOT: ``phase_launches`` of ROOT's package and of this
    tree's, one process each (this script with --package-root ROOT, then
    without), in turns ROOT, this, this, ROOT: a step's launches and the
    slice's steps/s of each."""
    runs = {"baseline": [], "this tree": []}
    for who in ("baseline", "this tree", "this tree", "baseline"):
        cmd = [sys.executable, os.path.abspath(__file__), "--phases", "device,build,launches"]
        if who == "baseline":
            cmd += ["--package-root", os.path.abspath(root)]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO, timeout=600)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[launches] ")]
        if proc.returncode != 0 or not lines:
            raise RuntimeError(f"the launches turn of {who} failed ({proc.returncode}):\n"
                               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        runs[who].append(json.loads(lines[-1][len("[launches] "):]))
        log(f"[profile] turn {who}: {runs[who][-1]}")
    out = {who: {k: statistics.median(r[k] for r in rs) for k in rs[0]}
           for who, rs in runs.items()}
    log(f"[profile] in turns (baseline {root}, this, this, baseline): device launches a step "
        f"{out['baseline']['device_launches']:.1f} -> {out['this tree']['device_launches']:.1f}"
        f" ({out['baseline']['device_launches'] - out['this tree']['device_launches']:.1f} "
        f"fewer); outermost aten ops a step {out['baseline']['aten_ops']:.1f} -> "
        f"{out['this tree']['aten_ops']:.1f}; steps/s {out['baseline']['steps_per_s']:.3f} -> "
        f"{out['this tree']['steps_per_s']:.3f} (each the median of two turns; all: {runs})")
    check_step_launches(out["this tree"], "launch_turns")
    return out


class OpRecorder:
    """A TorchDispatchMode that records every aten op it sees (forward and
    backward: the autograd engine's threads carry the mode): its name, a
    fingerprint of each tensor input before the op and of each output after
    it, and where it ran (the innermost f2nerf_torch frame; for a backward
    op, that of its forward op, which anomaly mode records on the node).
    With ``replay`` each op also runs a second time, on clones of its
    inputs, and the fingerprints of that output are kept too: an op whose
    two outputs differ depends on the order of its float sums (or of its
    writes). A fingerprint is an int64 sum of the tensor's bits times fixed
    weights: an integer sum, so it does not depend on its order. Ops that
    allocate without writing have no output fingerprint; random ops are not
    replayed (they would move the generators)."""

    SKIP = ("aten.empty", "aten.empty_like", "aten.empty_strided", "aten.new_empty",
            "aten.new_empty_strided")
    RANDOM = ("rand", "normal", "uniform", "bernoulli", "exponential", "multinomial",
              "cauchy", "geometric", "log_normal")

    def __init__(self, replay: bool = False):
        from torch.utils import _pytree
        from torch.utils._python_dispatch import TorchDispatchMode

        rec = self
        self.ops = []
        self.replay = replay
        self.weights = torch.empty(0, dtype=torch.int64, device=DEV)

        def clone(t):
            return t.clone() if isinstance(t, torch.Tensor) else t

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                name = str(func.overloadpacket)
                ins = rec.prints(args, kwargs)
                again = None
                if rec.replay and ins and name not in OpRecorder.SKIP \
                        and not any(r in name for r in OpRecorder.RANDOM):
                    a2, k2 = _pytree.tree_map(clone, (args, kwargs))
                    again = rec.prints((func(*a2, **k2),), {})
                out = func(*args, **kwargs)
                outs = None if name in OpRecorder.SKIP else rec.prints((out,), {})
                rec.ops.append((name, ins, outs, again, rec.where(),
                                bool(getattr(func, "is_view", False))))
                return out

        self.mode = Mode()

    def weights_for(self, n: int) -> torch.Tensor:
        if self.weights.numel() < n:
            i = torch.arange(max(n, 1 << 20), dtype=torch.int64, device=DEV)
            self.weights = (i * 2654435761) % 2147483647 + 1
        return self.weights[:n]

    def prints(self, args, kwargs) -> list:
        from torch.utils import _pytree
        out = []
        for t in _pytree.tree_leaves((args, kwargs)):
            if not isinstance(t, torch.Tensor) or t.device.type != torch.device(DEV).type \
                    or t.is_sparse:
                continue
            x = t.detach().contiguous().reshape(-1)
            if x.dtype == torch.bool:
                x = x.to(torch.uint8)
            if x.is_floating_point() or x.is_complex():
                x = x.view({8: torch.int64, 4: torch.int32, 2: torch.int16,
                            1: torch.uint8}[x.element_size()])
            x = x.to(torch.int64)
            out.append((x * self.weights_for(x.numel())).sum())
        return out

    def host_ops(self) -> list:
        """The records with their fingerprints on the host, as int lists."""
        def host(p):
            return None if p is None else (torch.stack(p).cpu().tolist() if p else [])
        return [(n, host(i), host(o), host(g), w, v) for n, i, o, g, w, v in self.ops]

    @staticmethod
    def where() -> str:
        import traceback
        node = torch._C._current_autograd_node()
        if node is not None:
            lines = [ln for ln in node.metadata.get("traceback_", []) if "f2nerf_torch" in ln]
            return (f"{node.name()} <- " + lines[-1].strip().splitlines()[0]) if lines \
                else node.name()
        frames = [f for f in traceback.extract_stack() if "f2nerf_torch" in f.filename]
        return f"{frames[-1].filename.split('f2nerf_torch')[-1]}:{frames[-1].lineno}" \
            if frames else "?"

    def __enter__(self):
        self.anomaly = torch.autograd.detect_anomaly(check_nan=False)
        self.anomaly.__enter__()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)
        self.anomaly.__exit__(*exc)


def phase_atomics(tr, where: str = "atomics") -> dict:
    """One slice step run twice from one state (``trainer_snapshot``) with
    one set of draws, torch's deterministic algorithms off, every aten op
    recorded (``OpRecorder``). The first run replays each op on clones of
    its inputs: an op whose two outputs differ depends on the order of its
    float sums (an atomic) or of its writes, and is printed with where it
    ran and how many times a step. Across the two runs, an op whose inputs
    are the same bits and whose outputs differ is printed too, and so is
    the first op whose inputs and outputs differ with no such op before it
    (where a hand-written kernel's difference would enter; a view op, or
    an op whose outputs agree, passes no difference on: its inputs may
    hold memory not yet written); each leaf's gradient is
    compared bit for bit. Printed, not held (the slice phase's
    ``step_twice`` holds the leaves)."""
    import collections
    import warnings
    from f2nerf_torch.utils.tree import named_leaves

    tr.freeze_controller()                 # one bucket and one set of caps for both
    snap = trainer_snapshot(tr)
    n_rays = tr.cur_batch_size()
    _, st = tr._get_step(n_rays)
    draws = tr.draw(st, n_rays)
    runs = []
    for replay in (True, False):
        restore_snapshot(tr, snap)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")        # anomaly mode warns
            with OpRecorder(replay) as rec:
                tr.train_one(draws=draws)
            torch.cuda.synchronize()
        grads = {k: v.grad.detach().clone() for k, v in named_leaves(tr.params)
                 if v.grad is not None}
        runs.append((rec.host_ops(), grads))
        del rec
    (a, ga), (b, gb) = runs
    if [o[0] for o in a] != [o[0] for o in b]:
        raise AssertionError("the two runs of one step ran different op sequences")
    replayed = collections.Counter((n, w) for n, _, o, g, w, _ in a
                                   if g is not None and o is not None and o != g)
    across = collections.Counter()
    first_input_diff = None
    for (name, ia, oa, _, at, view), (_, ib, ob, _, _, _) in zip(a, b):
        if ia == ib and oa is not None and oa != ob:
            across[(name, at)] += 1
        elif ia != ib and oa != ob and not view and first_input_diff is None \
                and not across:
            # a view of memory that an op has yet to write (torch.empty),
            # or an op that overwrites it whole, carries no difference on
            first_input_diff = (name, at)
    leaves = {k: bits_equal(ga[k], gb[k]) for k in ga}
    log(f"[{where}] one step twice from iteration {tr.iter_step - 1}, n_rays {n_rays}, "
        f"{len(a)} aten ops a run (forward and backward), torch deterministic off: "
        f"{len(replayed)} op sites whose output differed when the op ran again on "
        f"the same inputs, {len(across)} whose output differed across the runs on "
        f"the same inputs")
    for (name, at), k in replayed.most_common():
        log(f"[{where}]   replayed: {name} x{k} at {at}")
    for (name, at), k in across.most_common():
        log(f"[{where}]   across the runs: {name} x{k} at {at}")
    log(f"[{where}] first op whose inputs differ with no order-dependent op before it "
        f"(a hand-written kernel's difference): {first_input_diff}")
    log(f"[{where}] gradient leaves bit for bit: {leaves}")
    restore_snapshot(tr, snap)
    tr.freeze_controller(False)
    return dict(replayed=[list(k) + [v] for k, v in replayed.items()],
                across=[list(k) + [v] for k, v in across.items()], leaves=leaves,
                first_input_diff=first_input_diff)


def phase_ref_atomics(tmp: str) -> dict:
    """Not run by default (--phases device,build,ref_atomics [--package-root
    ROOT]): variants (a)'s trainer (REF_OVERRIDES at full width), VAR_STEPS
    steps uncounted, then ``phase_atomics`` on it: the order-dependent ops
    of the reference-semantics step, printed (the variants phase holds its
    leaves bit for bit: step_twice, chunk_parity)."""
    from f2nerf_torch.train.trainer import Trainer
    from f2nerf_torch.utils.synthetic import write_ball_dataset
    tr = Trainer(_compose(REF_OVERRIDES), os.path.join(tmp, "exp_ref_atomics"),
                 write_ball_dataset(os.path.join(tmp, "ball_ref_atomics")), seed=2022,
                 device=DEV)
    _train_checked(tr, VAR_STEPS, "ref_atomics")
    return phase_atomics(tr, "atomics (a)")


def step_parity(tr, max_hits: int, where: str, single_pass: bool = False) -> None:
    """One step from the trainer's saved state and one set of draws, card
    vs CPU, at the first controller bucket's shapes and ``max_hits``, held
    to the tolerances of f2nerf_torch/utils/parity.py. The trainer's
    config picks the field and the marcher; ``single_pass`` the statics'
    single pass (B = A, cap2 = cap1)."""
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
                        cap1=cap1, cap2=cap1 if single_pass else cap2,
                        max_hits=max_hits)._replace(single_pass=single_pass)
    gen = torch.Generator(device="cpu").manual_seed(7)
    draws_cpu = draw_step(gen, tr.dataset.device_arrays("cpu"), st, n_rays,
                          tr.dataset.height, tr.dataset.width, tr.tree)
    res = {}
    for name, dev in (("cuda", DEV), ("cpu", "cpu")):
        t = tr if name == "cuda" else Trainer(
            cfg, tr.base_exp_dir, tr.dataset.data_path, device="cpu",
            tree_host=tr.tree_host)
        t.load_checkpoint()
        core = make_core(cfg, st, t.dataset.height, t.dataset.width)
        draws = {k: v.to(dev) for k, v in draws_cpu.items()}
        t0 = time.perf_counter()
        tree, aux, grads = core(t.params, t.opt_state, t.tree, t.consts, t.data,
                                t.runtime(), draws, n_rays)
        res[name] = dict(
            loss=float(aux["loss"]), secs=time.perf_counter() - t0,
            n=float(aux["stats"]["n_meaningful"]), lr=float(t.runtime()["lr"]),
            params={k: v.detach().cpu() for k, v in named_leaves(t.params)},
            grads={k: v.detach().cpu() for k, v in named_leaves(grads)},
            occ={k: getattr(tree, k).cpu() for k in OCC_FIELDS})
    a, b = res["cuda"], res["cpu"]
    err = step_errors(a["loss"], b["loss"], a["grads"], b["grads"], a["params"],
                      b["params"], a["occ"], b["occ"], b["lr"])
    p_abs = max((a["params"][k] - b["params"][k]).abs().max().item() for k in b["params"])
    log(f"[{where}] iteration {tr.iter_step}, {tr.tree_host.n_nodes} nodes, hit cap "
        f"{max_hits}, {st.field_type}/{st.march_mode}/single_pass={st.single_pass}: "
        f"loss cuda {a['loss']:.7f} cpu {b['loss']:.7f}; meaningful samples "
        f"cuda {a['n']:.0f} cpu {b['n']:.0f}; errors {err} (tolerances {STEP_TOL}); "
        f"max |param diff| {p_abs:.3e} at lr {b['lr']:.3e}; "
        f"step seconds cuda {a['secs']:.2f} cpu {b['secs']:.2f}")
    if not step_agrees(err):
        raise AssertionError("card and CPU steps disagree beyond the stated tolerances")


def tree_counts(t) -> dict:
    return dict(nodes=int(t.n_nodes), leaves=int(t.is_leaf.sum()),
                valid=int((t.trans_idx >= 0).sum()))


class MaintenanceSpy:
    """Records each octree maintenance the Trainer runs while active: the
    iteration, the tree's nodes, leaves and valid leaves before and after,
    and the host seconds of ``maintain`` and of the ``to_device_tree`` that
    follows it (synchronised). It wraps the module functions the Trainer
    calls; the real ones run as always."""

    def __init__(self):
        from f2nerf_torch.sampler import device as dv
        from f2nerf_torch.sampler import octree as oc
        self.mods = (oc, dv)
        self.real = (oc.maintain, dv.to_device_tree)
        self.events = []

    def __enter__(self):
        oc, dv = self.mods
        real_maintain, real_upload = self.real

        def maintain(tree, iter_step, *a):
            before = tree_counts(tree)
            t0 = time.perf_counter()
            out, changed = real_maintain(tree, iter_step, *a)
            self.events.append(dict(iter=iter_step, before=before, after=tree_counts(out),
                                    changed=changed, maintain_s=time.perf_counter() - t0,
                                    upload_s=None))
            return out, changed

        def upload(*a, **kw):
            t0 = time.perf_counter()
            out = real_upload(*a, **kw)
            torch.cuda.synchronize()
            if self.events and self.events[-1]["upload_s"] is None:
                self.events[-1]["upload_s"] = time.perf_counter() - t0
            return out

        oc.maintain, dv.to_device_tree = maintain, upload
        return self

    def __exit__(self, *exc):
        oc, dv = self.mods
        oc.maintain, dv.to_device_tree = self.real


def _train_checked(tr, n: int, where: str, spy=None) -> list[dict]:
    """n train_one steps, each printed; losses and gradients finite. A
    maintenance event the spy recorded in a step gets the trainer's
    max_nodes and hit cap after it."""
    out = []
    for _ in range(n):
        m = tr.train_one()
        if spy is not None and spy.events and "max_nodes" not in spy.events[-1]:
            spy.events[-1].update(max_nodes=tr.max_nodes, hit_cap=tr.hit_cap)
        log(f"[{where}] iteration {tr.iter_step}: n_rays {m['n_rays']} hit_cap "
            f"{m['hit_cap']} loss {m['loss']:.6f} traverse_iters {m['trav_iters']} "
            f"oct_hits/ray {m['n_oct_hits'] / m['n_rays']:.1f} max {m['max_oct_hits']:.0f} "
            f"truncated {m['n_trav_truncated']:.0f} meaningful {m['n_meaningful']:.0f} "
            f"nodes {tr.tree_host.n_nodes}")
        if not np.isfinite(m["loss"]) or m["grads_finite"] != 1.0:
            raise AssertionError(f"{where}: non-finite loss or gradients at "
                                 f"iteration {tr.iter_step}: {m}")
        out.append(m)
    return out


def phase_maintain(tmp: str, rows: list[dict]) -> dict:
    """Octree maintenance on the card, in three parts:
      (a) the slice's config with compact_freq 10 and milestones [20, 40],
          50 steps: maintenance at 10, 20, 30, 40, 50, each printed (counts
          before and after, max_nodes, hit cap, host seconds of maintain and
          of the device-tree upload); the node count rises at each milestone,
          no milestone is left, K3 launches once a step;
      (b) one step card vs CPU on the subdivided tree (step_parity);
      (c) milestones [0, 0, 0]: the first maintenance (after step 1) runs
          three brute-force subdivisions (>= 150,000 nodes), then 5 steps
          timed: steps/s, rays/s, traversal iterations, hit cap, peak memory;
          then K8 and K9 at one more step's inputs on that tree against
          their plain versions (``subdivided_`` keys of their rows).
    Returns the launches of (a)."""
    from f2nerf_torch.train.trainer import Trainer
    from f2nerf_torch.utils.synthetic import write_ball_dataset
    from f2nerf_torch.utils.tree import named_leaves

    data_dir = write_ball_dataset(os.path.join(tmp, "ball_maintain"))
    tr = Trainer(_compose(MAINT_OVERRIDES), os.path.join(tmp, "exp_maintain"),
                 data_dir, seed=2022, device="cuda")
    n_leaves = len(list(named_leaves(tr.params)))
    log(f"[maintain] (a) {MAINT_OVERRIDES}: start {tree_counts(tr.tree_host)}, "
        f"max_nodes {tr.max_nodes}, hit_cap {tr.hit_cap}")
    reset_counts()
    with MaintenanceSpy() as spy:
        ms = _train_checked(tr, MAINT_STEPS, "maintain", spy)
    torch.cuda.synchronize()
    launches = read_counts()
    for e in spy.events:
        log(f"[maintain] event at iteration {e['iter']}: before {e['before']}, after "
            f"{e['after']}; max_nodes {e['max_nodes']}, hit_cap {e['hit_cap']}; "
            f"maintain {e['maintain_s']:.4f} s host, to_device_tree {e['upload_s']:.4f} s")
    log(f"[maintain] (a) end: max_nodes {tr.max_nodes}, hit_cap {tr.hit_cap}, "
        f"milestones {tr.tree_host.milestones}; launches {launches}")
    for m in MAINT_MILESTONES:
        before = [x["trav_iters"] for x in ms[m - 5:m]]
        after = [x["trav_iters"] for x in ms[m:m + 5]]
        log(f"[maintain] traversal iterations, 5 steps before / after the milestone "
            f"at {m}: {before} / {after}")
    if [e["iter"] for e in spy.events] != MAINT_EVENTS:
        raise AssertionError(f"maintenance ran at {[e['iter'] for e in spy.events]}, "
                             f"expected {MAINT_EVENTS}")
    for e in spy.events:
        if e["iter"] in MAINT_MILESTONES and not e["after"]["nodes"] > e["before"]["nodes"]:
            raise AssertionError(f"the milestone at {e['iter']} did not subdivide: {e}")
    if tr.tree_host.milestones:
        raise AssertionError(f"milestones left: {tr.tree_host.milestones}")
    check_counts("the maintain phase (a)", launches, {
        "fused_adam": MAINT_STEPS * n_leaves, "hash_block_fwd": MAINT_STEPS,
        "row_gather": MAINT_STEPS, **seg_need(MAINT_STEPS), **warp_need(MAINT_STEPS)},
        exact={"hash_block_bwd": MAINT_STEPS,
                                           "traverse": MAINT_STEPS,
                                           "ray_march_parallel": MAINT_STEPS})

    step_parity(tr, max_hits=tr.hit_cap, where="maintain (b)")
    del tr
    torch.cuda.empty_cache()

    over = ["pts_sampler.sub_div_milestones=[0,0,0]"]
    tr = Trainer(_compose(over), os.path.join(tmp, "exp_maintain_real"), data_dir,
                 seed=2022, device="cuda")
    start = tree_counts(tr.tree_host)
    reset_counts()
    with MaintenanceSpy() as spy:
        _train_checked(tr, 1, "maintain (c)", spy)
    e, = spy.events
    log(f"[maintain] (c) {over}: maintenance after iteration 1: {start} -> {e['after']}; "
        f"maintain {e['maintain_s']:.4f} s host, to_device_tree {e['upload_s']:.4f} s; "
        f"max_nodes {tr.max_nodes}, hit_cap {tr.hit_cap}")
    if e["after"]["nodes"] < REAL_SCALE_MIN_NODES:
        raise AssertionError(f"real scale reached {e['after']['nodes']} nodes, "
                             f"expected >= {REAL_SCALE_MIN_NODES}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ms = _train_checked(tr, REAL_SCALE_STEPS, "maintain (c)")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    real = read_counts()
    log(f"[maintain] (c) {REAL_SCALE_STEPS} steps on {tr.tree_host.n_nodes} nodes: "
        f"{REAL_SCALE_STEPS / dt:.3f} steps/s, {sum(m['n_rays'] for m in ms) / dt:.1f} "
        f"rays/s; traverse_iters {[m['trav_iters'] for m in ms]}; hit_cap "
        f"{[m['hit_cap'] for m in ms]}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches {real}")
    n = 1 + REAL_SCALE_STEPS
    check_counts("the maintain phase (c)", real, {
        "fused_adam": n * n_leaves, "hash_block_fwd": n, "row_gather": n, **warp_need(n)},
        exact={"hash_block_bwd": n, "traverse": n, "ray_march_parallel": n})
    from f2nerf_torch.sampler import device as dv
    calls = capture_calls(tr, {"traverse": dv, "ray_march_parallel": dv})
    label = f"step's own inputs on {tr.tree_host.n_nodes} nodes"
    at = {"traverse": traverse_case(calls["traverse"][0], label),
          "ray_march_parallel": march_parallel_case(calls["ray_march_parallel"][0], label)}
    del calls
    for r in rows:
        if r["name"] in at:
            r.update({f"subdivided_{k}": v for k, v in at[r["name"]].items()},
                     max_abs_err=max(r["max_abs_err"], at[r["name"]]["max_abs_err"]))
    return launches


class TrainAutoSpy(list):
    """The (iteration, chunk) of every ``Trainer.train_auto`` call made
    while active; the real method runs as always."""

    def __enter__(self):
        from f2nerf_torch.train.trainer import Trainer
        self.real = real = Trainer.train_auto
        calls = self

        def train_auto(tr, *a, **kw):
            s = tr.iter_step
            out = real(tr, *a, **kw)
            calls.append((s, tr.iter_step - s))
            return out
        Trainer.train_auto = train_auto
        return self

    def __exit__(self, *exc):
        from f2nerf_torch.train.trainer import Trainer
        Trainer.train_auto = self.real


def phase_runner(tmp: str):
    """The port's CLI at full width: mode=train (40 iterations, then the
    test render), then mode=render_path from the checkpoint. Checks the
    artifact set and each run's launches; then times Trainer.render_image
    over all 24 cameras. Returns the render_path run's Runner."""
    from f2nerf_torch import run as cli
    from f2nerf_torch.data import dataset as ds
    from f2nerf_torch.utils.synthetic import write_ball_dataset
    from f2nerf_torch.utils.tree import named_leaves

    work = os.path.join(tmp, "work")
    data_dir = write_ball_dataset(os.path.join(work, "data", "synth", "ball"))
    cams = np.load(os.path.join(data_dir, "cams_meta.npy"))
    np.save(os.path.join(data_dir, "poses_render.npy"),
            np.ascontiguousarray(cams[:3, :12].reshape(-1, 3, 4).astype(np.float64)))
    args = ["--config-name=wanjinyou", f"+work_dir={work}", "dataset_name=synth",
            "case_name=ball", "exp_name=smoke", "dataset.factor=1",
            "+train.fused_adam=true", f"train.end_iter={RUNNER_ITERS}",
            "train.report_freq=10", "train.vis_freq=20", "train.stats_freq=20",
            "train.save_freq=30"]
    cwd = os.getcwd()
    os.chdir(work)              # the CLI writes runtime_config.yaml here
    try:
        reset_counts()
        t0 = time.perf_counter()
        with TrainAutoSpy() as chunks:
            runner = cli.main(args + ["mode=train"])
        torch.cuda.synchronize()
        train_counts = read_counts()
        log(f"[runner] mode=train: {time.perf_counter() - t0:.2f} s; train_auto "
            f"(iteration, chunk) calls {chunks}; launches {train_counts}")
        if chunks != RUNNER_CHUNKS:
            raise AssertionError(f"the Runner stepped {chunks}, expected {RUNNER_CHUNKS}")
        tr = runner.trainer
        n_leaves = len(list(named_leaves(tr.params)))
        check_counts("mode=train", train_counts, {
            "fused_adam": RUNNER_ITERS * n_leaves, "hash_block_fwd": RUNNER_ITERS,
            "row_gather": RUNNER_ITERS, "traverse": RUNNER_ITERS,
            "ray_march_parallel": RUNNER_ITERS, **seg_need(RUNNER_ITERS),
            **warp_need(RUNNER_ITERS)},
            exact={"hash_block_bwd": RUNNER_ITERS})
        exp, test_set = runner.base_exp_dir, [int(i) for i in tr.dataset.test_set]
        del runner, tr
        torch.cuda.empty_cache()

        reset_counts()
        t0 = time.perf_counter()
        runner = cli.main(args + ["mode=render_path", "is_continue=true"])
        torch.cuda.synchronize()
        eval_counts = read_counts()
        log(f"[runner] mode=render_path: {time.perf_counter() - t0:.2f} s; "
            f"launches {eval_counts}")
        # eval renders single-pass: one K2, K8 and K9 launch per chunk, no
        # cached gather
        check_counts("mode=render_path", eval_counts, {
            "hash_block_fwd": 3, "traverse": 3, "ray_march_parallel": 3,
            **seg_need(3, single_pass=True), **warp_need(3, train=False, two_pass=False)})
        if eval_counts["row_gather"] or eval_counts["fused_adam"] \
                or eval_counts["compute_occupancy_adders"] or eval_counts["sample_edges"]:
            raise AssertionError(f"render_path launched training kernels: {eval_counts}")
    finally:
        os.chdir(cwd)

    step = RUNNER_ITERS
    want = ["train_info.txt", "stats.npy", "cam_pos.ply", "octree.obj",
            "record/runtime_config.yaml", "record/f2nerf_torch/csrc/row_gather.cu",
            "test_images/info.yaml", "test_images/info.json",
            "checkpoints/00000030/state.npz", "checkpoints/latest/state.npz"]
    want += [f"test_images/{k}_{step}_{i:03d}.png" for i in test_set
             for k in ("color", "depth", "oct_depth")]
    # the vis panels of iterations 20 and 40 (a swallowed vis failure fails here)
    want += [f"images/{s}_{test_set[(s // 20) % len(test_set)]}.png" for s in (20, 40)]
    want += [f"novel_images/{step}_{i:03d}.png" for i in range(3)]
    missing = [w for w in want if not os.path.exists(os.path.join(exp, w))]
    if missing:
        raise AssertionError(f"the runner did not write {missing}")
    with np.load(os.path.join(exp, "checkpoints", "latest", "state.npz")) as z:
        if int(z["iter_step"]) != step:
            raise AssertionError(f"checkpoints/latest is at {int(z['iter_step'])}")
    import yaml
    with open(os.path.join(exp, "test_images", "info.yaml")) as f:
        info = yaml.safe_load(f)
    with open(os.path.join(exp, "test_images", "info.json")) as f:
        full = json.load(f)
    log(f"[runner] test PSNR after {step} iterations: {info} (a smoke value); "
        f"mean SSIM {full['ssim']['mean']:.4f}; lpips {full['lpips']['mean']}")
    if not (np.isfinite(info["mean_psnr"]) and full["lpips"]["mean"] is None):
        raise AssertionError(f"bad test metrics: {info}")

    # eval throughput: every camera's rays in one render_image call
    tr = runner.trainer
    h, w = tr.dataset.height, tr.dataset.width
    rays = [ds.camera_rays(tr.data, i, h, w) for i in range(tr.dataset.n_images)]
    ro = torch.cat([r[0] for r in rays])
    rd = torch.cat([r[1] for r in rays])
    chunk = int(tr.cfg.get("eval", {}).get("chunk", 4096))
    tr.render_image(ro, rd)                               # warm-up
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(2):
        t0 = time.perf_counter()
        colors, _, _ = tr.render_image(ro, rd)            # returns host arrays
        secs.append(time.perf_counter() - t0)
    n = ro.shape[0]
    log(f"[runner] render_image over {tr.dataset.n_images} cameras: {n} rays in "
        f"{-(-n // chunk)} chunks of {chunk}: {[round(s, 4) for s in secs]} s, "
        f"{n / min(secs):.1f} rays/s, {min(secs) / tr.dataset.n_images:.4f} s per "
        f"{h}x{w} image; chunks rendered again {len(tr.last_redo)}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if not np.isfinite(colors).all():
        raise AssertionError("non-finite colours in render_image")
    return runner


def trainer_state(tr) -> dict:
    """Params, Adam first moments and occupancy counters, on the host."""
    from f2nerf_torch.utils.tree import named_leaves
    return dict(params={k: v.detach().cpu() for k, v in named_leaves(tr.params)},
                mu={k: v.cpu() for k, v in named_leaves(tr.opt_state["mu"])},
                occ={k: getattr(tr.tree, k).cpu() for k in OCC_FIELDS})


def leaf_outliers(a: dict, b: dict) -> dict:
    """Per leaf: (entries differing by more than STEP_TOL's param_atol,
    entries, the largest difference)."""
    from f2nerf_torch.utils.parity import STEP_TOL
    out = {}
    for k in b:
        d = (a[k] - b[k]).abs()
        out[k] = (int((d > STEP_TOL["param_atol"]).sum()), d.numel(), float(d.max()))
    return out


def trainer_snapshot(tr) -> dict:
    """The trainer's training state, kept on the card: the iteration, the
    params and Adam state (cloned) and the tree (each step makes a new
    one). The frozen controller's state does not move."""
    from f2nerf_torch.utils.tree import named_leaves
    return dict(iter_step=tr.iter_step, tree=tr.tree,
                params={k: v.detach().clone() for k, v in named_leaves(tr.params)},
                opt={k: v.clone() for k, v in named_leaves(tr.opt_state)})


def restore_snapshot(tr, snap: dict) -> None:
    from f2nerf_torch.utils.tree import named_leaves
    with torch.no_grad():
        for k, v in named_leaves(tr.params):
            v.copy_(snap["params"][k])
        for k, v in named_leaves(tr.opt_state):
            v.copy_(snap["opt"][k])
    tr.tree, tr.iter_step = snap["tree"], snap["iter_step"]


def chunk_parity(tr, k: int = BENCH_CHUNK, where: str = "bench") -> None:
    """``train_many(k)`` against k ``train_one`` calls from one state
    (``trainer_snapshot``) with one set of draws, at the trainer's frozen
    controller, held to
    STEP_TOL (the Adam first moments standing for the gradients, the k
    steps' learning rates summed as the step bound's unit) with equal
    n_rays, caps and hit cap, and bit for bit: every param, Adam first
    moment and occupancy counter the same bits (the exact difference is
    printed). The pair runs twice: under torch's deterministic
    algorithms, then with them off, as every run of the port is. Both are
    held: the segment ops (K10, K11) and the table-gradient scatters (K3,
    K6) sum in a fixed order. (Before K10/K11, torch's float atomics moved the
    second pair 20-191x past STEP_TOL's outlier bound over 3 steps; before
    K3's order-fixed redesign the pairs agreed only within STEP_TOL;
    PERF.md §6.)"""
    import warnings
    from f2nerf_torch.utils.parity import STEP_TOL, step_agrees, step_errors

    snap = trainer_snapshot(tr)
    n_rays = tr.cur_batch_size()
    _, st = tr._get_step(n_rays)
    draws = [tr.draw(st, n_rays) for _ in range(k)]
    lr = sum(float(rt["lr"]) for rt in tr._runtimes(k))
    statics = ("n_rays", "cap1", "cap2", "hit_cap", "single_pass")
    for deterministic in (True, False):
        ends = {}
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")   # an op without a deterministic form warns
                for name in ("train_many", "train_one"):
                    restore_snapshot(tr, snap)
                    t0 = time.perf_counter()
                    last = tr.train_many(k, draws=draws) if name == "train_many" else \
                        [tr.train_one(draws=d) for d in draws][-1]
                    torch.cuda.synchronize()
                    ends[name] = dict(trainer_state(tr), last=last, mse=tr.mse_records[-k:],
                                      secs=time.perf_counter() - t0)
        finally:
            torch.use_deterministic_algorithms(False)
        a, b = ends["train_many"], ends["train_one"]
        err = step_errors(a["last"]["loss"], b["last"]["loss"], a["mu"], b["mu"], a["params"],
                          b["params"], a["occ"], b["occ"], lr)
        leaves = [(part, k) for part in ("params", "mu", "occ") for k in b[part]]
        differ = [f"{part} {k}" for part, k in leaves if not bits_equal(a[part][k], b[part][k])]
        exact = max(float((a[part][k].double() - b[part][k].double()).abs().max())
                    for part, k in leaves)
        log(f"[{where}] train_many({k}) vs {k} train_one from iteration {tr.iter_step - k}, "
            f"{'torch deterministic' if deterministic else 'torch atomics'}: "
            f"{ {f: a['last'][f] for f in statics} } vs { {f: b['last'][f] for f in statics} }; "
            f"mse {a['mse']} vs {b['mse']}; errors {err} (tolerances {STEP_TOL}); per leaf "
            f"(entries over param_atol, entries, max |diff|) "
            f"{leaf_outliers(a['params'], b['params'])}; exact difference: {len(differ)} of "
            f"{len(leaves)} leaves differ {differ}, max |diff| {exact!r}; seconds "
            f"{a['secs']:.3f} vs {b['secs']:.3f}")
        if any(a["last"][f] != b["last"][f] for f in statics):
            raise AssertionError("train_many and train_one ran different statics")
        if not step_agrees(err):
            raise AssertionError(f"train_many and train_one disagree beyond STEP_TOL "
                                 f"(deterministic {deterministic})")
        if differ:
            raise AssertionError(f"train_many and train_one differ in {differ} "
                                 f"(deterministic {deterministic}; max |diff| {exact!r})")


def phase_bench(tmp: str) -> dict:
    """The benchmark entry at full width on the ball scene (the
    wanjinyou widths; F2_BENCH_SYNTH=1, no checkpoint):
      (a) ``run_bench``: settle, freeze, 40 pipelined steps; its JSON line;
      (b) a second trainer from ``bench.prepare``, timed in turns of
          BENCH_TURN_STEPS (``bench.time_steps``): synced single steps,
          pipelined chunks, pipelined chunks, synced single steps, each
          turn's rays/s printed; K1-K4 launches counted over the first
          pipelined turn (K3 and K4 once an iteration);
      (c) ``chunk_parity`` on that trainer.
    Returns the launches of (b)'s counted turn."""
    from f2nerf_torch import bench
    from f2nerf_torch.utils.tree import named_leaves

    os.environ["F2_BENCH_SYNTH"] = "1"
    os.environ["F2_BENCH_CKPT"] = "0"
    over = ["+train.fused_adam=true"]          # the full widths, not TINY
    t0 = time.perf_counter()
    out = bench.run_bench(over, settle=BENCH_SETTLE, timed_steps=BENCH_STEPS)
    log(f"[bench] run_bench (settle {BENCH_SETTLE}, {BENCH_STEPS} timed steps) in "
        f"{time.perf_counter() - t0:.2f} s: {json.dumps(out)}")
    if not (out["unit"] == "rays/sec" and np.isfinite(out["value"]) and out["value"] > 0):
        raise AssertionError(f"bad bench line: {out}")
    torch.cuda.empty_cache()

    tr, workload, n_rays = bench.prepare(os.path.join(tmp, "bench"), over,
                                         settle=BENCH_SETTLE)
    n_leaves = len(list(named_leaves(tr.params)))
    log(f"[bench] {workload}: frozen at iteration {tr.iter_step}, n_rays {n_rays}, "
        f"chunk {tr.chunk_size}, pipeline depth {tr.pipeline_depth}")
    launches = None
    for turn, pipelined in enumerate((False, True, True, False)):
        if launches is None and pipelined:
            reset_counts()
        it0 = tr.iter_step
        iters, secs = bench.time_steps(tr, BENCH_TURN_STEPS, pipelined)
        if launches is None and pipelined:
            launches = read_counts()
            check_counts("the bench's pipelined chunks", launches, {
                "fused_adam": iters * n_leaves, "hash_block_fwd": 2 * iters,
                **seg_need(iters)},
                exact={"hash_block_bwd": iters, "row_gather": iters,
                       "hash_encode_fwd": 0, "hash_encode_bwd": 0, "ray_march": 0,
                       "traverse": iters, "ray_march_parallel": iters,
                       **{k: iters for k in warp_need(1)}})
        log(f"[bench] turn {turn}: {'pipelined chunks' if pipelined else 'synced single steps'}"
            f", iterations {it0}-{tr.iter_step}: {iters / secs:.3f} steps/s, "
            f"{iters * n_rays / secs:.1f} rays/s"
            + (f"; launches {launches}" if turn == 1 else ""))
    if not np.isfinite(tr.psnr_smooth):
        raise AssertionError("non-finite PSNR after the bench turns")
    chunk_parity(tr)
    del tr
    torch.cuda.empty_cache()
    return launches


def phase_eval_parity(runner) -> None:
    eval_image_parity(runner.trainer, "eval_parity", saved=True)


def cpu_copy(card, save: bool = True):
    """A CPU Trainer at the card trainer's state (its checkpoint, its tree
    and hit cap)."""
    from f2nerf_torch.train.trainer import Trainer
    if save:
        card.save_checkpoint()
    cpu = Trainer(card.cfg, card.base_exp_dir, card.dataset.data_path,
                  device="cpu", tree_host=card.tree_host)
    cpu.load_checkpoint()
    cpu.hit_cap = card.hit_cap
    if (cpu.iter_step, cpu.ema_sampled) != (card.iter_step, card.ema_sampled):
        raise AssertionError("the CPU trainer did not load the card's state")
    return cpu


def eval_image_parity(card, where: str, saved: bool = False) -> None:
    """One test camera from the trainer's checkpoint (written first unless
    ``saved``): render_image on the card (kernels) and on the CPU (plain
    versions), held to EVAL_TOL (f2nerf_torch/utils/parity.py), the same
    chunks rendered again."""
    from f2nerf_torch.data import dataset as ds
    from f2nerf_torch.utils.parity import EVAL_TOL, eval_agrees, image_errors

    cpu = cpu_copy(card, save=not saved)
    cam = int(cpu.dataset.test_set[0])
    ro, rd = ds.camera_rays(cpu.data, cam, cpu.dataset.height, cpu.dataset.width)
    out, secs, redo = {}, {}, {}
    for name, t in (("cuda", card), ("cpu", cpu)):
        t0 = time.perf_counter()
        out[name] = t.render_image(ro, rd)
        secs[name], redo[name] = time.perf_counter() - t0, list(t.last_redo)
    (ca, da, oa), (cb, db, ob) = out["cuda"], out["cpu"]
    err = image_errors(ca, da, cb, db)
    oct_err = float(np.abs(oa - ob).max())
    log(f"[{where}] camera {cam}, {ro.shape[0]} rays: errors {err}, "
        f"first_oct_dis {oct_err:.3e} (tolerances {EVAL_TOL}); chunks rendered "
        f"again cuda {redo['cuda']} cpu {redo['cpu']}; seconds cuda "
        f"{secs['cuda']:.2f} cpu {secs['cpu']:.2f}")
    if redo["cuda"] != redo["cpu"]:
        raise AssertionError("card and CPU rendered different chunks again")
    if not (eval_agrees(err, exact=False) and oct_err <= EVAL_TOL["oct_atol"]):
        raise AssertionError("card and CPU images disagree beyond the stated tolerances")


def two_pass_eval_parity(card, where: str, want: dict) -> None:
    """One two-pass eval ``render`` (prefilter, A -> B, the field on B:
    HashBlock by the cached gather, Hash3DAnchored by a full query) of a
    test camera's rays, card vs CPU from one checkpoint, held to EVAL_TOL;
    the card's launches must include ``want`` (at least)."""
    from f2nerf_torch.data import dataset as ds
    from f2nerf_torch.render.renderer import render
    from f2nerf_torch.train import schedules
    from f2nerf_torch.train.trainer import render_statics
    from f2nerf_torch.utils.parity import EVAL_TOL, eval_agrees, image_errors

    cpu = cpu_copy(card)
    fineness = schedules.ray_march_fineness(card.iter_step, card.cfg["train"])
    cam = int(cpu.dataset.test_set[0])
    n, max_s = 1024, 256
    st = render_statics(card.cfg, n, card.dataset.near, train=False, max_s=max_s,
                        cap1=n * max_s, cap2=n * 64, max_hits=card.hit_cap)
    out = {}
    for name, t in (("cuda", card), ("cpu", cpu)):
        ro, rd = (x[:n] for x in ds.camera_rays(t.data, cam, t.dataset.height,
                                                 t.dataset.width))
        dev = ro.device
        reset_counts()
        with torch.no_grad():
            res, occ = render(t.params, t.consts, t.tree, ro, rd,
                              torch.zeros((n,), dtype=torch.int32, device=dev), None,
                              torch.full((), fineness, device=dev),
                              torch.ones((), device=dev), st)
        if name == "cuda":
            torch.cuda.synchronize()
            counts = read_counts()
        out[name] = dict(stats={k: float(v) for k, v in res["stats"].items()},
                         colors=res["colors"].cpu(), disp=res["disparity"].cpu())
    a, b = out["cuda"], out["cpu"]
    err = image_errors(a["colors"], a["disp"], b["colors"], b["disp"])
    log(f"[{where}] two-pass eval render, {st.field_type}/{st.march_mode}, camera "
        f"{cam}, {n} rays, fineness {fineness:g}, cap1 {st.cap1} cap2 {st.cap2}: sampled {a['stats']['n_sampled']:.0f} "
        f"kept {a['stats']['n_meaningful']:.0f} (cpu {b['stats']['n_sampled']:.0f} / "
        f"{b['stats']['n_meaningful']:.0f}); errors {err} (tolerances {EVAL_TOL}); "
        f"card launches {counts}")
    check_counts(where, counts, want, exact={"compact_keep": 1, "ray_offsets": 0})
    if a["stats"]["n_sampled"] != b["stats"]["n_sampled"] or occ is not None:
        raise AssertionError("card and CPU sampled differently (or eval voted)")
    if not eval_agrees(err, exact=False):
        raise AssertionError("card and CPU two-pass renders disagree beyond EVAL_TOL")


def capture_calls(tr, names: dict) -> dict:
    """One more training step with the given wrappers spied on ({name:
    module}): the arguments of every call, in order. The real wrappers run
    as always."""
    calls = {name: [] for name in names}
    real = {name: getattr(mod, name) for name, mod in names.items()}

    def spy(name):
        def fn(*args):
            calls[name].append(args)
            return real[name](*args)
        fn.launches = 0
        return fn

    try:
        for name, mod in names.items():
            setattr(mod, name, spy(name))
        tr.train_one()
        torch.cuda.synchronize()
    finally:
        for name, mod in names.items():
            setattr(mod, name, real[name])
    return calls


def march_uniform_args(tr, gen, R: int = 1536, max_s: int = 512, H: int = 64):
    """K7's uniform case on the trainer's tree: R rays with origins
    uniform in [-1, 1]^3 and uniform directions, their hits at hit cap H,
    a training noise draw times the initial fineness 16."""
    from f2nerf_torch.sampler import device as dv
    dev = torch.device(DEV)
    o = torch.rand((R, 3), generator=gen, device=dev) * 2.0 - 1.0
    d = torch.randn((R, 3), generator=gen, device=dev)
    d = d / dv.norm3(d)[:, None]
    near = torch.full((R,), float(tr.cfg["pts_sampler"]["near"]), device=dev)
    hits = dv.traverse(tr.tree, o, d, near, torch.full((R,), 1e8, device=dev), H)[:4]
    noise = ((torch.rand((R + max_s + 16,), generator=gen, device=dev) - 0.5) + 1.0) * 16.0
    return (tr.tree, o, d, *hits, noise, float(tr.cfg["pts_sampler"]["sample_l"]),
            bool(tr.cfg["pts_sampler"]["scale_by_dis"]), max_s)


def march_cases(tr, step_args: tuple) -> tuple[dict, dict]:
    """K7 at one step's own inputs and at the uniform shape."""
    return (march_case(step_args, "step's own inputs"),
            march_case(march_uniform_args(tr, torch.Generator(device=DEV).manual_seed(5)),
                       "uniform rays, hit cap 64"))


def phase_march(tmp: str) -> None:
    """K7 alone, for kernel sweeps (not run by default: --phases
    device,build,march): variants (a)'s trainer after VAR_STEPS steps,
    then K7 at one more step's own inputs and at the uniform shape, as the
    variants phase measures it, and at the uniform shape with an eval
    chunk's 4,096 rays (more warps than an SM holds at once)."""
    from f2nerf_torch.sampler import device as dv
    from f2nerf_torch.train.trainer import Trainer
    from f2nerf_torch.utils.synthetic import write_ball_dataset
    tr = Trainer(_compose(REF_OVERRIDES), os.path.join(tmp, "exp_march"),
                 write_ball_dataset(os.path.join(tmp, "ball_march")), seed=2022,
                 device=DEV)
    _train_checked(tr, VAR_STEPS, "march")
    (step_args,) = capture_calls(tr, {"ray_march": dv})["ray_march"]
    march_cases(tr, step_args)
    march_case(march_uniform_args(tr, torch.Generator(device=DEV).manual_seed(5), R=4096),
               "uniform rays, hit cap 64, 4,096 rays")


def phase_variants(tmp: str, rows: list[dict], profile: bool = False,
                   baseline: str | None = None) -> dict:
    """The configurations beside the default slice, on the card:
      (a) the reference-semantics config (REF_OVERRIDES: the Hash3DAnchored
          field, the lockstep marcher) at full width: VAR_STEPS steps timed
          over TIME_FROM..VAR_STEPS (steps/s, rays/s, peak memory); every
          step launches K5 twice (A's prefilter, B + edges), K6 and K7
          once, K2/K3/K4 never; K5/K6/K7 at one step's own inputs (spied;
          both K5 launches) and K7 at a uniform shape, each against its
          plain version (K6 also beside its library call, and with
          ``baseline`` in turns with ROOT's K6); one step run twice from
          one state bit for bit (``step_twice``) and ``chunk_parity``,
          both held; one step card vs CPU; render_image over the 24
          cameras (eval rays/s) and one image card vs CPU;
      (b) HashBlock with +train.single_pass=true: SINGLE_PASS_STEPS steps,
          each single pass (B = A), K3 once a step, K4 and K13 never, the
          offsets launch once a step with K12's offsets given; the offsets
          launch at one more step's own A and offsets (its row's ms,
          plain_ms and bound_ms); one step card vs CPU;
      (c) data_at_gpu=false and ray_sample_mode=single_image: HOST_STEPS
          steps each; then Trainer.reset and one step;
      (d) one two-pass eval render card vs CPU for each field (K13 once,
          the offsets launch never).
    With ``profile``, phase_profile runs on (a)'s trainer after its timed
    steps. Returns the launches of (a) and of (b), by path name."""
    from f2nerf_torch.fields import hash_encoding as he
    from f2nerf_torch.ops import segment as sg
    from f2nerf_torch.sampler import device as dv
    from f2nerf_torch.train.trainer import Trainer
    from f2nerf_torch.utils.synthetic import write_ball_dataset
    from f2nerf_torch.utils.tree import named_leaves

    data_dir = write_ball_dataset(os.path.join(tmp, "ball_variants"))
    # ---- (a) the reference-semantics config
    tr = Trainer(_compose(REF_OVERRIDES), os.path.join(tmp, "exp_ref"), data_dir,
                 seed=2022, device=DEV)
    # (b) and (c) start from the same octree (their configs build the same
    # one), copied before (a)'s checkpoints sync occupancy into it
    tree0 = copy.deepcopy(tr.tree_host)
    n_leaves = len(list(named_leaves(tr.params)))
    log(f"[variants] (a) {REF_OVERRIDES}: feat_pool {tuple(tr.params['feat_pool'].shape)}")
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    rays, t_start = 0, None
    for step in range(1, VAR_STEPS + 1):
        if step == TIME_FROM:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        m = tr.train_one()
        if step >= TIME_FROM:
            rays += m["n_rays"]
        log(f"[variants] (a) step {step}: n_rays {m['n_rays']} cap1 {m['cap1']} cap2 "
            f"{m['cap2']} hit_cap {m['hit_cap']} loss {m['loss']:.6f} traverse_iters "
            f"{m['trav_iters']} sampled {m['n_sampled']:.0f} meaningful "
            f"{m['n_meaningful']:.0f} saturated {m['n_saturated']:.0f}")
        if not np.isfinite(m["loss"]) or m["grads_finite"] != 1.0:
            raise AssertionError(f"(a): non-finite loss or gradients at step {step}")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t_start
    launches = read_counts()
    n_timed = VAR_STEPS - TIME_FROM + 1
    log(f"[variants] (a) steps {TIME_FROM}-{VAR_STEPS}: {n_timed / dt:.3f} steps/s, "
        f"{rays / dt:.1f} rays/s; peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
        f"GiB; launches {launches}")
    check_counts("variants (a)", launches, {"fused_adam": VAR_STEPS * n_leaves,
                                            **seg_need(VAR_STEPS)}, exact={
        **{k: VAR_STEPS for k in warp_need(1)},
        "hash_encode_fwd": 2 * VAR_STEPS, "hash_encode_bwd": VAR_STEPS,
        "ray_march": VAR_STEPS, "hash_block_fwd": 0, "hash_block_bwd": 0,
        "row_gather": 0, "traverse": VAR_STEPS, "ray_march_parallel": 0})
    if profile:
        phase_profile(tr, where="profile (a)")

    if rows:
        calls = capture_calls(tr, {"hash_encode_fwd": he, "hash_encode_bwd": he,
                                   "ray_march": dv})
        # K5's two launches, each timed at its own inputs; the row keeps A's
        a_fwd, b_fwd = calls["hash_encode_fwd"]
        k5 = [hash3d_encode_case(a_fwd, f"step's A at {a_fwd[3].shape[0]}"),
              hash3d_encode_case(b_fwd, f"step's B + edges at {b_fwd[3].shape[0]}")]
        at = {"hash_encode_fwd": dict(k5[0], max_abs_err=max(r["max_abs_err"] for r in k5),
                                      step_launches=[dict(launch=w, **r) for w, r in
                                                     zip(("A", "B + edges"), k5)]),
              "hash_encode_bwd": hash3d_scatter_case(calls["hash_encode_bwd"][0],
                                                     "step's B + edges", library=True)}
        if baseline:
            at["hash_encode_bwd"].update({f"{case}_{k}": v for case, r in baseline_k6_turns(
                baseline, {"step": calls["hash_encode_bwd"][0]}).items()
                for k, v in r.items()})
        log("[variants] (a) K5 a step: " + "; ".join(
            f"{w} n={r['n']} {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({100 * r['bound_ms'] / r['ms']:.1f}% of it)"
            for w, r in zip(("A", "B + edges"), k5)) +
            f"; launches x (time - bound) {sum(r['ms'] - r['bound_ms'] for r in k5):.4f} ms")
        (march,) = calls["ray_march"]
        del calls, a_fwd, b_fwd
        at["ray_march"], r7 = march_cases(tr, march)
        del march
        rows.append(dict(name="ray_march", route="cuda", source="f2nerf_torch/csrc/ray_march.cu",
                         replaces="f2nerf_tpu/sampler/device.py:436", library_ms=None,
                         library=NO_LIBRARY_MARCH, path="variants (a)",
                         bound_by=at["ray_march"]["bound_by"],
                         **{f"uniform_{k}": v for k, v in r7.items()},
                         max_abs_err=max(r7["max_abs_err"], at["ray_march"]["max_abs_err"])))
        for r in rows:
            new = at.get(r["name"])
            if new is not None:
                r.update({k: new[k] for k in ("ms", "plain_ms", "bound_ms")},
                         max_abs_err=max(r["max_abs_err"], new["max_abs_err"]),
                         **{f"slice_{k}": v for k, v in new.items()})
                if new.get("library_ms") is not None:
                    r["library_ms"] = new["library_ms"]
                r["launches_per_step"] = launches[r["name"]] / VAR_STEPS

    # (a)'s step is reproducible: K6 sums in a fixed order
    step_twice(tr, "variants (a)")
    tr.freeze_controller()
    chunk_parity(tr, where="variants (a)")
    tr.freeze_controller(False)
    step_parity(tr, max_hits=64, where="variants (a) parity")
    h, w = tr.dataset.height, tr.dataset.width
    from f2nerf_torch.data import dataset as ds
    cams = [ds.camera_rays(tr.data, i, h, w) for i in range(tr.dataset.n_images)]
    ro, rd = torch.cat([c[0] for c in cams]), torch.cat([c[1] for c in cams])
    tr.render_image(ro, rd)                                  # warm-up
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    colors, _, _ = tr.render_image(ro, rd)
    secs = time.perf_counter() - t0
    ev = read_counts()
    log(f"[variants] (a) render_image over {tr.dataset.n_images} cameras: {ro.shape[0]} "
        f"rays in {secs:.4f} s, {ro.shape[0] / secs:.1f} rays/s, {secs / tr.dataset.n_images:.4f} "
        f"s per {h}x{w} image; chunks rendered again {len(tr.last_redo)}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches {ev}")
    if not np.isfinite(colors).all():
        raise AssertionError("(a): non-finite colours in render_image")
    check_counts("variants (a) render_image", ev, {"hash_encode_fwd": 1, "ray_march": 1,
                                                   "traverse": 1,
                                                   **seg_need(1, single_pass=True),
                                                   **warp_need(1, train=False, two_pass=False)},
                 exact={"hash_block_fwd": 0, "hash_encode_bwd": 0, "ray_march_parallel": 0})
    eval_image_parity(tr, "variants (a) eval parity")
    two_pass_eval_parity(tr, "variants (d)", {"hash_encode_fwd": 2, "ray_march": 1,
                                              "traverse": 1})
    del tr
    torch.cuda.empty_cache()

    # ---- (b) single-pass training, HashBlock
    tr = Trainer(_compose(["+train.single_pass=true"]), os.path.join(tmp, "exp_single"),
                 data_dir, seed=2022, device=DEV, tree_host=copy.deepcopy(tree0))
    reset_counts()
    sg.ray_offsets.given_launches = 0
    ms = _train_checked(tr, SINGLE_PASS_STEPS, "variants (b)")
    torch.cuda.synchronize()
    sp = read_counts()
    given = sg.ray_offsets.given_launches
    log(f"[variants] (b) +train.single_pass=true: single pass at every step "
        f"{[m['single_pass'] for m in ms]}, cap1 = cap2 {[m['cap1'] == m['cap2'] for m in ms]}; "
        f"launches {sp}; the offsets launch with K12's offsets given {given} times")
    if not all(m["single_pass"] and m["cap1"] == m["cap2"] for m in ms):
        raise AssertionError("(b): a step ran two passes")
    if given != SINGLE_PASS_STEPS:
        raise AssertionError(f"(b): the offsets launch had the offsets given {given} times, "
                             f"expected {SINGLE_PASS_STEPS}")
    for r in rows:
        if r.get("path") == "variants (b)":
            r["launches_per_step"] = sp[r["name"]] / SINGLE_PASS_STEPS
    check_counts("variants (b)", sp, seg_need(SINGLE_PASS_STEPS, single_pass=True), exact={
        "ray_offsets": SINGLE_PASS_STEPS,
        **{k: SINGLE_PASS_STEPS for k in warp_need(1, two_pass=False)}, "compact_keep": 0,
        "hash_block_fwd": SINGLE_PASS_STEPS, "hash_block_bwd": SINGLE_PASS_STEPS,
        "row_gather": 0, "hash_encode_fwd": 0, "ray_march": 0,
        "traverse": SINGLE_PASS_STEPS, "ray_march_parallel": SINGLE_PASS_STEPS})
    if rows:
        # the offsets launch at (b)'s own step: K12's A and its offsets, given
        from f2nerf_torch.render import renderer
        (off_args,) = capture_calls(tr, {"ray_offsets": renderer})["ray_offsets"]
        rid_a, n_rays, offsets_a = off_args
        r = ray_offsets_case(rid_a, n_rays, "single-pass step's own A and K12's offsets",
                             given=offsets_a)
        del off_args, rid_a, offsets_a
        for row in rows:
            if row["name"] == "ray_offsets":
                row.update(ms=r["given_ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                           max_abs_err=max(row["max_abs_err"], r["max_abs_err"]),
                           **{f"slice_{k}": v for k, v in r.items()})
    step_parity(tr, max_hits=64, where="variants (b) parity", single_pass=True)
    two_pass_eval_parity(tr, "variants (d)", {"hash_block_fwd": 1, "row_gather": 1,
                                              "traverse": 1, "ray_march_parallel": 1})
    del tr
    torch.cuda.empty_cache()

    # ---- (c) the host loader, single-image sampling, reset
    for k, over in enumerate((["dataset.data_at_gpu=false"],
                              ["dataset.ray_sample_mode=single_image"])):
        tr = Trainer(_compose(over), os.path.join(tmp, f"exp_host{k}"), data_dir,
                     seed=2022, device=DEV, tree_host=copy.deepcopy(tree0))
        if over[0].startswith("dataset.data_at_gpu") and "train_images" in tr.data:
            raise AssertionError("(c): the training images went to the card")
        t0 = time.perf_counter()
        _train_checked(tr, HOST_STEPS, f"variants (c) {over[0]}")
        torch.cuda.synchronize()
        log(f"[variants] (c) {over}: {HOST_STEPS} steps in {time.perf_counter() - t0:.3f} s")
    before = tr.params["feat_pool"].detach().clone()
    tr.reset()
    pool = tr.params["feat_pool"].detach()
    if torch.equal(pool, before) or float(pool.abs().max()) > 1e-2 \
            or int(tr.opt_state["count"]) != 0:
        raise AssertionError("(c): reset did not re-initialise the pool and Adam")
    _train_checked(tr, 1, "variants (c) after reset")
    del tr
    torch.cuda.empty_cache()
    return {"variants (a)": launches, "variants (b)": sp}


def phase_configs(tmp: str) -> dict:
    """The configurations beside wanjinyou (CONFIGS: confs/llff.yaml,
    free.yaml, nerf-360.yaml, wanjinyou_big.yaml), each composed on the
    ball scene at its own full width with +train.fused_adam=true (no
    other override: llff's factor 4, its bounds_factor and
    disp_loss_weight 5e-2, the appearance embedding off in the paper's
    three, wanjinyou_big's [16, 32768, 128] HashBlock table): CONFIG_STEPS
    steps each (steps/s and rays/s over steps TIME_FROM on, peak memory,
    cap1/cap2, hit cap, K1-K4's launches: K3 and K4 once a step, K2 at
    least once; the other kernels of the path at least once), then one
    step run twice from one state bit for bit (``step_twice``); llff also
    one step card vs CPU (``step_parity``). Any failure fails the phase.
    Returns the kernels' launches over the four configs."""
    from f2nerf_torch.fields import hash_block as hb
    from f2nerf_torch.train.trainer import Trainer
    from f2nerf_torch.utils.synthetic import write_ball_dataset
    from f2nerf_torch.utils.tree import named_leaves

    data_dir = write_ball_dataset(os.path.join(tmp, "ball_configs"))
    total = {}
    for name in CONFIGS:
        cfg = _compose(config=name)
        t0 = time.perf_counter()
        tr = Trainer(cfg, os.path.join(tmp, f"exp_{name}"), data_dir, seed=2022, device=DEV)
        torch.cuda.synchronize()
        shape = tuple(tr.params["feat_pool"].shape)
        want = (16, hb.n_blocks(int(cfg["field"]["log2_table_size"])), hb.LANES)
        log(f"[configs] {name}: Trainer built in {time.perf_counter() - t0:.2f} s; field "
            f"{cfg['field']['type']} {shape}; use_app_emb {cfg['renderer']['use_app_emb']}, "
            f"scale_by_dis {cfg['pts_sampler']['scale_by_dis']}, dataset.factor "
            f"{cfg['dataset']['factor']}, disp_loss_weight {cfg['train']['disp_loss_weight']}; "
            f"{tr.tree_host.n_nodes} nodes")
        if shape != want or (name == "wanjinyou_big" and shape != (16, 32768, 128)):
            raise AssertionError(f"{name}: HashBlock table {shape}, expected {want}")
        n_leaves = len(list(named_leaves(tr.params)))
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        rays, t_start = 0, None
        for step in range(1, CONFIG_STEPS + 1):
            if step == TIME_FROM:
                torch.cuda.synchronize()
                t_start = time.perf_counter()
            m = tr.train_one()
            if step >= TIME_FROM:
                rays += m["n_rays"]
            log(f"[configs] {name} step {step}: n_rays {m['n_rays']} cap1 {m['cap1']} cap2 "
                f"{m['cap2']} hit_cap {m['hit_cap']} loss {m['loss']:.6f} meaningful "
                f"{m['n_meaningful']:.0f}")
            if not np.isfinite(m["loss"]) or m["grads_finite"] != 1.0:
                raise AssertionError(f"{name}: non-finite loss or gradients at step {step}")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t_start
        launches = read_counts()
        n_timed = CONFIG_STEPS - TIME_FROM + 1
        log(f"[configs] {name} steps {TIME_FROM}-{CONFIG_STEPS}: {n_timed / dt:.3f} steps/s, "
            f"{rays / dt:.1f} rays/s; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; K1-K4 launches "
            f"{ {k: launches[k] for k in KERNEL_ORDER[:4]} }; all launches {launches}")
        check_counts(f"configs {name}", launches, {
            "fused_adam": CONFIG_STEPS * n_leaves, "hash_block_fwd": CONFIG_STEPS,
            "traverse": CONFIG_STEPS, "ray_march_parallel": CONFIG_STEPS,
            **seg_need(CONFIG_STEPS), **warp_need(CONFIG_STEPS)},
            exact={"hash_block_bwd": CONFIG_STEPS, "row_gather": CONFIG_STEPS,
                   "hash_encode_fwd": 0, "hash_encode_bwd": 0, "ray_march": 0,
                   "rays_kernel": CONFIG_STEPS})
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        step_twice(tr, f"configs {name}")
        if name == "llff":
            step_parity(tr, max_hits=64, where="configs llff parity")
        del tr
        torch.cuda.empty_cache()
    return total


# ------------------------------------------------------------ data parallel

def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class TimedReduce:
    """A trainer's cross-rank reduction (``Trainer.reduce``) with each
    call's wall time on the host, the device synchronised on both sides."""

    def __init__(self, fn):
        self.fn, self.ms = fn, []

    def __call__(self, *args):
        _sync()
        t0 = time.perf_counter()
        out = self.fn(*args)
        _sync()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


def replica_checksums(tr) -> torch.Tensor:
    """Two int64 checksums a tensor of the trainer's params, Adam state and
    device tree (its bits, summed plain and position-weighted; overflow
    wraps alike everywhere), then the controller state's f64 bits: equal on
    two ranks only if those ranks hold the same bits, short of a collision."""
    from f2nerf_torch.utils.tree import named_leaves
    tensors = [v for _, v in named_leaves(tr.params)] + \
        [v for _, v in named_leaves(tr.opt_state)] + \
        [getattr(tr.tree, f) for f in tr.tree.__dataclass_fields__
         if torch.is_tensor(getattr(tr.tree, f))]
    sums = []
    for t in tensors:
        t = t.detach().reshape(-1)
        bits = (t.view(torch.int32) if t.dtype == torch.float32 else t).to(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device) % 1009 + 1
        sums += [bits.sum(), (bits * w).sum()]
    ctl = [tr.ema_sampled, tr.ema_meaningful, tr.ema_oct, tr.trunc_ema, tr.sat_ema,
           tr.b_trunc_ema, tr.oct_max, tr.psnr_smooth, tr.hit_cap, tr._cur_bucket,
           tr.iter_step] + [c for k in sorted(tr._cap_memo) for c in (k, *tr._cap_memo[k])]
    ctl = torch.tensor(ctl, dtype=torch.float64).view(torch.int64).to(sums[0].device)
    return torch.cat([torch.stack(sums), ctl])


def dp_rank(rank: int, world: int, tmp: str, data_dir: str, device: str,
            overrides: list, iters: int) -> None:
    """One gloo rank of the data_parallel phase (a spawned process): a
    Trainer at the given config trains ``iters`` iterations through
    ``train_auto`` (chunks of 10), timed over the second half; its launch
    counts, the collectives' ms a step, steps/s, rays/s and whether the
    replica checksums agree across ranks (all-reduced MIN and MAX) go to
    ``<tmp>/dp_rank<rank>.json``."""
    from f2nerf_torch.parallel import data_parallel as dp
    from f2nerf_torch.train.trainer import Trainer
    from f2nerf_torch.utils.tree import named_leaves

    dp.init_distributed(backend="gloo", init_method="file://" + os.path.join(tmp, "gloo_pg"),
                        world_size=world, rank=rank, timeout_s=300)
    try:
        tr = Trainer(_compose(overrides), os.path.join(tmp, f"dp_rank{rank}"), data_dir,
                     seed=2022, device=device)
        timed = tr.reduce = TimedReduce(tr.reduce)
        reset_counts()
        rays, t0, losses = 0, None, []
        while tr.iter_step < iters:
            if t0 is None and tr.iter_step >= iters // 2:
                _sync()
                t0, rays, n_timed, it0 = time.perf_counter(), 0, len(timed.ms), tr.iter_step
            s = tr.iter_step
            m = tr.train_auto()
            rays += (tr.iter_step - s) * m["n_rays"]
            losses.append(m["loss"])
            if not (np.isfinite(m["loss"]) and m["grads_finite"] == 1.0):
                raise AssertionError(f"rank {rank}: non-finite step at iteration {s}: {m}")
        _sync()
        secs = time.perf_counter() - t0
        sums = replica_checksums(tr)
        lo, hi = sums.clone(), sums.clone()
        torch.distributed.all_reduce(lo, op=torch.distributed.ReduceOp.MIN)
        torch.distributed.all_reduce(hi, op=torch.distributed.ReduceOp.MAX)
        out = dict(rank=rank, n_shards=tr.n_shards, launches=read_counts(),
                   replicated=bool(torch.equal(lo, hi)), n_checksums=sums.numel(),
                   timed_from=it0, steps_per_s=(iters - it0) / secs, rays_per_s=rays / secs,
                   reduce_ms=statistics.median(timed.ms[n_timed:]),
                   reduce_ms_all=[round(x, 3) for x in timed.ms], losses=losses,
                   n_rays=m["n_rays"], n_local_rows=int(tr.data["train_ids"].numel()),
                   n_leaves=len(named_leaves(tr.params)))
        with open(os.path.join(tmp, f"dp_rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()


def run_dp_ranks(tmp: str, data_dir: str, device: str, overrides: list, iters: int,
                 world: int = 2, timeout_s: float = 300.0) -> list[dict]:
    """``world`` gloo ranks (``dp_rank``) as spawned processes; a rank that
    fails or outlives ``timeout_s`` fails the phase, and every process is
    ended before this returns."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=dp_rank, args=(r, world, tmp, data_dir, device,
                                                overrides, iters))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.pid is not None:       # started
                if p.is_alive():
                    p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise AssertionError(f"data_parallel ranks exited with {codes}")
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"dp_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def phase_data_parallel(tmp: str) -> dict:
    """The data-parallel path (f2nerf_torch/parallel/data_parallel.py) on the
    card, at full width on the ball scene:
      (a) world size 1 on NCCL: one step from one state with one set of
          draws through a Trainer under the process group (its step
          all-reduces) against a plain Trainer, under torch's
          deterministic algorithms, held to STEP_TOL; then DP_STEPS more
          steps timed (the collectives' ms a step);
      (b) two gloo ranks sharing cuda:0 (NCCL refuses two ranks on one
          card; gloo stages CUDA tensors through the host): DP_ITERS
          iterations through train_auto on each, params, Adam state, tree
          and controller state bitwise equal across the ranks (all-reduced
          checksums), K1-K4 launched on each rank, losses finite; steps/s,
          rays/s and the collectives' ms a step printed. Two ranks on one
          card: not a scaling figure.
    Returns rank 0's launches of (b)."""
    import warnings
    from f2nerf_torch.parallel import data_parallel as dp
    from f2nerf_torch.train.trainer import Trainer
    from f2nerf_torch.utils.parity import STEP_TOL, step_agrees, step_errors
    from f2nerf_torch.utils.synthetic import write_ball_dataset
    from f2nerf_torch.utils.tree import named_leaves

    data_dir = os.path.join(tmp, "ball")
    if not os.path.isdir(data_dir):
        write_ball_dataset(data_dir)
    cfg = _compose()
    plain = Trainer(cfg, os.path.join(tmp, "dp_plain"), data_dir, seed=2022, device=DEV)
    dp.init_distributed(backend="nccl", init_method="file://" + os.path.join(tmp, "nccl_pg"),
                        world_size=1, rank=0)
    try:
        tr = Trainer(cfg, os.path.join(tmp, "dp_nccl"), data_dir, seed=2022, device=DEV)
        if tr.reduce is None or tr.n_shards != 1:
            raise AssertionError("the Trainer under a process group does not reduce")
        timed = tr.reduce = TimedReduce(tr.reduce)
        n_rays = plain.cur_batch_size()
        _, st = plain._get_step(n_rays)
        draws = plain.draw(st, n_rays)
        lr = float(plain.runtime()["lr"])
        ends = {}
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                for name, t in (("plain", plain), ("nccl", tr)):
                    ends[name] = dict(trainer_state(t), last=t.train_one(draws=draws))
        finally:
            torch.use_deterministic_algorithms(False)
        a, b = ends["nccl"], ends["plain"]
        err = step_errors(a["last"]["loss"], b["last"]["loss"], a["mu"], b["mu"],
                          a["params"], b["params"], a["occ"], b["occ"], lr)
        log(f"[data_parallel] (a) world size 1 on NCCL vs the plain trainer, one step "
            f"(n_rays {n_rays}, torch deterministic): errors {err} (tolerances {STEP_TOL}); "
            f"per leaf (entries over param_atol, entries, max |diff|) "
            f"{leaf_outliers(a['params'], b['params'])}")
        if not step_agrees(err):
            raise AssertionError("the NCCL world-size-1 step disagrees beyond STEP_TOL")
        del plain
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DP_STEPS):
            m = tr.train_one()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        log(f"[data_parallel] (a) {DP_STEPS} more steps at world size 1 on NCCL: "
            f"{DP_STEPS / secs:.3f} steps/s, n_rays {m['n_rays']}; the collectives "
            f"(all-reduce SUM of {sum(p.numel() for _, p in named_leaves(tr.params))} gradient "
            f"floats + metrics, all-reduce MAX of the votes) {statistics.median(timed.ms):.3f} "
            f"ms a step (median; all {[round(x, 3) for x in timed.ms]})")
        del tr
    finally:
        torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()

    ranks = run_dp_ranks(tmp, data_dir, DEV, [], DP_ITERS)
    for r in ranks:
        log(f"[data_parallel] (b) gloo rank {r['rank']} of 2 on cuda:0 (two ranks on one "
            f"card, not a scaling figure): iterations {r['timed_from']}-{DP_ITERS}: "
            f"{r['steps_per_s']:.3f} steps/s, {r['rays_per_s']:.1f} rays/s (global "
            f"n_rays {r['n_rays']}); collectives {r['reduce_ms']:.3f} ms a step (median over "
            f"the timed steps; all {r['reduce_ms_all']}); {r['n_local_rows']} camera rows; "
            f"replicated across ranks ({r['n_checksums']} checksums): {r['replicated']}; "
            f"launches {r['launches']}; losses {r['losses']}")
        if not r["replicated"]:
            raise AssertionError("the two ranks' states differ")
        check_counts(f"data_parallel rank {r['rank']}", r["launches"], {
            "fused_adam": DP_ITERS * r["n_leaves"], "hash_block_fwd": DP_ITERS,
            **seg_need(DP_ITERS)},
            exact={"hash_block_bwd": DP_ITERS, "row_gather": DP_ITERS,
                   "hash_encode_fwd": 0, "hash_encode_bwd": 0, "ray_march": 0,
                   "traverse": DP_ITERS, "ray_march_parallel": DP_ITERS,
                   **{k: DP_ITERS for k in warp_need(1)}})
    return ranks[0]["launches"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--baseline", default=None, metavar="ROOT",
                    help="a checkout of an earlier tree: its atomic K6 (csrc/hash3d.cu, "
                         "with the zero-fill its wrapper did) timed in turns with this "
                         "tree's; "
                         "with the profile phase, its slice step's launches and steps/s "
                         "beside this tree's, one process each, in turns (ROOT, this, "
                         "this, ROOT)")
    ap.add_argument("--package-root", default=None, metavar="ROOT",
                    help="import f2nerf_torch from ROOT (how --baseline runs an "
                         "earlier tree's launches phase)")
    args = ap.parse_args(argv)
    if args.package_root:
        sys.path.insert(0, os.path.abspath(args.package_root))
    phases = args.phases.split(",")
    full = set(phases) == set(PHASES)
    walls = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        walls[name] = round(time.perf_counter() - t0, 2)
        log(f"[time] phase {name}: {walls[name]} s")
        return out

    dev_info = timed("device", phase_device)   # raises without CUDA, before any result
    if "build" in phases:
        timed("build", phase_build)
    rows = timed("kernels", phase_kernels, args.baseline) if "kernels" in phases else []
    launches = {}
    paths = {}            # each further path's launches, by its key in the rows
    with tempfile.TemporaryDirectory(prefix="f2smoke_") as tmp:
        if "slice" in phases:
            launches, tr, (cap1, cap2) = timed("slice", phase_slice, tmp)
            if rows:
                timed("kernels_at_slice_inputs", kernels_at_slice_inputs, rows, tr,
                      cap1, cap2, launches)
            if "profile" in phases:
                timed("profile", phase_profile, tr)
                if args.baseline:
                    timed("launch_turns", launch_turns, args.baseline)
            if "parity" in phases:
                timed("parity", step_parity, tr, 64, "parity")
            if "atomics" in phases:
                timed("atomics", phase_atomics, tr)
            del tr
            torch.cuda.empty_cache()
        elif {"profile", "atomics", "launches"} & set(phases):
            # the slice's steps without the launch counts: this script may
            # be timing an older tree's package
            tr = timed("steps", slice_steps, tmp, False)[0]
            if "launches" in phases:
                timed("launches", phase_launches, tr)
            if "profile" in phases:
                timed("profile", phase_profile, tr)
            if "atomics" in phases:
                timed("atomics", phase_atomics, tr)
            del tr
            torch.cuda.empty_cache()
        if "maintain" in phases:
            paths["maintain_launches"] = timed("maintain", phase_maintain, tmp, rows)
            torch.cuda.empty_cache()
        if "runner" in phases:
            runner = timed("runner", phase_runner, tmp)
            if "eval_parity" in phases:
                timed("eval_parity", phase_eval_parity, runner)
            del runner
            torch.cuda.empty_cache()
        if "bench" in phases:
            paths["bench_launches"] = timed("bench", phase_bench, tmp)
        if "march" in phases:
            timed("march", phase_march, tmp)
        var_launches = {}
        if "variants" in phases:
            var_launches = timed("variants", phase_variants, tmp, rows,
                                 "profile" in phases, args.baseline)
        if "configs" in phases:
            paths["configs_launches"] = timed("configs", phase_configs, tmp)
        if "ref_atomics" in phases:
            timed("ref_atomics", phase_ref_atomics, tmp)
        if "data_parallel" in phases:
            paths["data_parallel_launches"] = timed("data_parallel", phase_data_parallel, tmp)
    log(f"[time] phases (s): {walls}")
    for r in rows:
        # each kernel's launches on its own path: K5-K7 the reference-
        # semantics run, the offsets launch the single-pass run (b), the
        # others the default slice
        path = var_launches.get(r.get("path"), launches)
        r["launches"] = path.get(r["name"], 0)
        r.update({key: counts.get(r["name"], 0) for key, counts in paths.items()})
    rows.sort(key=lambda r: KERNEL_ORDER.index(r["name"]))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys + tuple(sorted(set(r) - set(keys)))}
                                  for r in rows]}))
    print(f"card: {dev_info['smi']}")
    if not full:
        return 0
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": dev_info["name"],
                                             "count": dev_info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
