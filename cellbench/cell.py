"""One run of one cell: set-up, the measured window, the check.

The cell's configuration (``configs/<name>.json``) and traffic mix
(``mixes/<name>.json``) say everything that differs between cells: the
configuration as it is run, the mix's mode (``train`` or ``render``), the
image size, the start iteration and the settle. The program under test is
``f2nerf_torch``; its Trainer is driven as its Runner drives it.

Set-up, in parts (``setup_parts``): the scene written under the run's
temporary directory; the Trainer built; the weights and hash constants
the benchmark makes from the seed copied into it; the iteration counter
set to the start and the octree subdivided (the configuration's
milestones at 0); the controller settled and frozen; then, by mode, the
check steps or the warm-up image.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import os
import time

import numpy as np
import torch

from .reference import data as ref_data
from .reference import octree as ref_octree
from .reference import step as ref

# the tree fields a training step changes (the occupancy fold); the others
# hold the octree's structure, its warps and edges, fixed between
# maintenance events, and none falls in a cell's run after the subdivision
FOLD_FIELDS = ("weight_stats", "alpha_stats", "visit_cnt", "trans_idx")


def host_copy(x):
    """A detached CPU copy of a tensor, or of each tensor in a dict/list."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: host_copy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(host_copy(v) for v in x)
    return x


def to_device(x, device):
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_device(v, device) for v in x)
    return x


def tree_fields(tree) -> dict:
    """The fields of a device tree (the program's dataclass) as a dict."""
    return {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    """One cell's run: ``setup``, then ``window``, then ``check``."""

    def __init__(self, cfg_doc: dict, mix: dict, seed: int, device: str, tmp: str):
        self.cfg_doc, self.mix, self.seed = cfg_doc, mix, int(seed)
        self.cfg = cfg_doc["config"]
        self.device = torch.device(device)
        self.tmp = tmp
        self.parts: dict[str, float] = {}
        self.info: dict = {}

    # ------------------------------------------------------------ set-up
    def _part(self, name: str, t0: float) -> float:
        sync(self.device)
        t = time.perf_counter()
        self.parts[name] = t - t0
        return t

    def setup(self) -> None:
        from f2nerf_torch.train.trainer import Trainer
        from .scene import write_scene

        mix, cfg = self.mix, self.cfg
        h, w = mix["image_hw"]
        factor = int(round(float(cfg["dataset"].get("factor", 1))))
        t = time.perf_counter()
        self.data_path = os.path.join(self.tmp, "scene")
        self.images = write_scene(self.data_path, h, w, factor)
        t = self._part("scene_s", t)
        tr = Trainer(cfg, os.path.join(self.tmp, "exp"), self.data_path,
                     seed=self.seed % (1 << 31), device=str(self.device))
        t = self._part("trainer_s", t)
        # the weights and hash constants: the benchmark's, from the seed
        self.gen = torch.Generator(device=self.device).manual_seed(self.seed)
        params, consts = ref.init_params(self.gen, cfg, len(self.images),
                                         max(tr.n_volumes, 1))
        with torch.no_grad():
            for (_, mine), theirs in zip(_leaves(params), _leaf_tensors(tr.params)):
                theirs.copy_(mine)
            for k in consts:
                tr.consts[k].copy_(consts[k])
        self.consts_host = host_copy(consts)
        del params, consts
        t = self._part("weights_s", t)
        tr.iter_step = int(mix["start_iter"])
        tr.maybe_maintain_tree()
        # the occupancy fields as the subdivision left them, for the tree's check
        self.built_fold = host_copy({k: getattr(tr.tree, k) for k in FOLD_FIELDS})
        t = self._part("subdivide_s", t)
        self.tr = tr
        self.settle()
        t = self._part("settle_s", t)
        if mix["mode"] == "train":
            self.check_steps()
        else:
            self.warm_render()
        # every window starts from the same state of Python's collector
        gc.collect()
        self._part("warm_s", t)

    def settle(self) -> None:
        """Train in chunks until the controller's bucket, caps and hit cap
        have not moved for ``stable_chunks`` chunks (at least
        ``min_steps`` steps, at most ``max_steps``), then freeze it."""
        tr, s = self.tr, self.mix["settle"]
        it0, key, same, out, path = tr.iter_step, None, 0, None, []
        while tr.iter_step - it0 < int(s["max_steps"]):
            out = tr.train_auto(sync=True)
            k = (out["n_rays"], out["cap1"], out["cap2"], out["hit_cap"], out["single_pass"])
            path.append([tr.iter_step - it0, out["n_rays"],
                         round(out["n_meaningful"] / out["n_rays"], 1)])
            same = same + 1 if k == key else 0
            key = k
            if same >= int(s["stable_chunks"]) and tr.iter_step - it0 >= int(s["min_steps"]):
                break
        tr.freeze_controller()
        self.step_key = dict(n_rays=out["n_rays"], cap1=out["cap1"], cap2=out["cap2"],
                             hit_cap=out["hit_cap"], single_pass=bool(out["single_pass"]))
        self.info["settle"] = dict(
            steps=tr.iter_step - it0, settled=same >= int(s["stable_chunks"]),
            **self.step_key, nodes=int(tr.tree_host.n_nodes),
            sampled_per_ray=out["n_sampled"] / out["n_rays"],
            meaningful_per_ray=out["n_meaningful"] / out["n_rays"],
            oct_hits_per_ray=out["n_oct_hits"] / out["n_rays"],
            overflow_a=out["overflow_a"], overflow_b=out["overflow_b"],
            path=path[::5] + path[-1:])

    def step_statics(self):
        """The training step's statics at the settled controller's sizes."""
        k = self.step_key
        pts = int(self.cfg["train"]["pts_batch_size"])
        return ref.statics(self.cfg, k["n_rays"], True, ref.max_s_for(k["n_rays"], pts),
                           k["cap1"], k["cap2"], k["hit_cap"], k["single_pass"])

    # ------------------------------------------------------------ train
    def check_steps(self) -> None:
        """The steps the reference follows: ``check_steps`` single-step
        chunks through ``train_many`` with draws the benchmark makes, from
        the settled state (kept on the host), then chunks to the next
        multiple of the chunk size, which warm the window's own call."""
        tr, n = self.tr, int(self.mix["check_steps"])
        st = self.step_statics()
        n_rays = self.step_key["n_rays"]
        ref_scene = ref_data.load_scene(self.data_path, self.images, self.cfg["dataset"],
                                        self.device)
        self.check_draws = [host_copy(ref.draw_step(
            self.gen, ref_scene, st, n_rays, tr.dataset.height, tr.dataset.width,
            tr.tree.n_edges)) for _ in range(n)]
        del ref_scene
        self.start = dict(iter=tr.iter_step, params=host_copy(tr.params),
                          opt=host_copy(tr.opt_state), tree=host_copy(tree_fields(tr.tree)))
        losses, first_mu, stats = [], None, []
        for i in range(n):
            out = tr.train_many(1, sync=True, draws=[to_device(self.check_draws[i], self.device)])
            losses.append(out["loss"])
            stats.append(dict(n_sampled=out["n_sampled"], n_meaningful=out["n_meaningful"],
                              overflow_b=out["overflow_b"]))
            if i == 0:
                first_mu = ref.leaf_norms(tr.opt_state["mu"])
        self.prog = dict(losses=losses, mu=first_mu,
                         change=_change_norms(tr.params, self.start["params"]),
                         tree=host_copy({k: getattr(tr.tree, k) for k in FOLD_FIELDS}))
        self.info["check_steps"] = stats
        chunk = int(self.cfg["train"].get("step_chunk", 10))
        while tr.iter_step % chunk:
            tr.train_many(chunk - tr.iter_step % chunk, sync=True)
        tr.train_auto(sync=True)

    def train_window(self, seconds: float) -> dict:
        """``train_auto(sync=False)`` as the Runner drives it, from one
        synchronize to the last call's return and a final synchronize."""
        tr = self.tr
        n_rays = self.step_key["n_rays"]
        rec0 = len(tr.mse_records)
        sync(self.device)
        t0 = time.perf_counter()
        it0 = tr.iter_step
        while time.perf_counter() - t0 < seconds:
            tr.train_auto(sync=False)
        sync(self.device)
        secs = time.perf_counter() - t0
        iters = tr.iter_step - it0
        tr.train_auto(sync=True)         # drain the metrics the window left pending
        mse = np.asarray(tr.mse_records[rec0:rec0 + iters], np.float64)
        return dict(seconds=secs, iterations=iters, rays=iters * n_rays,
                    failed=int((~np.isfinite(mse)).sum()), t0=t0)

    def check_train(self, lower: bool = False) -> dict:
        """The reference follows the check steps from the settled state with
        the same draws. Returns the numbers compared (``compare_train``)."""
        dev = self.device
        st = self.step_statics()
        params = map_requires_grad(to_device(self.start["params"], dev))
        opt = to_device(self.start["opt"], dev)
        tree, mismatch = self.reference_tree(self.start["tree"])
        consts = {k: v.to(dev) for k, v in self.consts_host.items()}
        scene = ref_data.load_scene(self.data_path, self.images, self.cfg["dataset"], dev)
        losses, mu = [], None
        ctx = ref.lower_precision() if lower else contextlib.nullcontext()
        with ctx:
            for i, draws in enumerate(self.check_draws):
                rt = ref.runtime(self.start["iter"] + i, self.cfg["train"], dev)
                tree, loss = ref.train_step(params, opt, tree, consts, scene, rt,
                                            to_device(draws, dev), self.step_key["n_rays"],
                                            self.cfg["train"], st)
                losses.append(loss)
                if i == 0:
                    mu = ref.leaf_norms(opt["mu"])
        change = _change_norms(params, self.start["params"])
        fold = {k: getattr(tree, k).cpu() for k in FOLD_FIELDS}
        start = {k: self.start["tree"][k] for k in FOLD_FIELDS}
        numbers, seen = compare_train(
            self.prog, dict(losses=losses, mu=mu, change=change, tree=fold), start)
        self.info["check"] = dict(seen, **self.info["tree"])
        return dict(numbers, tree_mismatch=mismatch)

    def reference_tree(self, prog_tree: dict):
        """The reference's own octree at the start iteration, built from
        the scene's cameras (``reference.octree.start_tree``), with the
        occupancy fields of the program's ``prog_tree`` in place: the state
        the program's settle left, which the reference does not follow.
        Also the number of entries in which the program's tree, as the
        subdivision left it, differs from the reference's (its structure
        from ``prog_tree``, its occupancy fields from ``built_fold``)."""
        t = time.perf_counter()
        mine = ref_octree.start_tree(ref_data.scene_cams(self.data_path, self.cfg["dataset"]),
                                     self.cfg, self.seed % (1 << 31),
                                     int(self.mix["start_iter"]), self.device)
        theirs = dict(prog_tree, **self.built_fold)
        mismatch = sum(_entries_differing(theirs[k], v) for k, v in mine.items())
        self.info["tree"] = dict(tree_build_s=time.perf_counter() - t, nodes=mine["n_nodes"],
                                 edges=mine["n_edges"])
        fields = dict(mine, **{k: prog_tree[k].to(self.device) for k in FOLD_FIELDS})
        return ref.device_tree(fields), mismatch

    # ------------------------------------------------------------ render
    def warm_render(self) -> None:
        """The cameras' rays (the benchmark's own, from the scene it wrote)
        and the first ``warm_chunks`` chunks of camera 0 rendered, which
        warms the window's shapes: the chunk, and the exact re-render of a
        chunk that truncates."""
        scene = ref_data.load_scene(self.data_path, self.images, self.cfg["dataset"],
                                    self.device)
        h, w = self.images.shape[1:3]
        self.rays = [ref_data.camera_rays(scene, c, h, w) for c in range(len(self.images))]
        del scene
        n = int(self.mix["warm_chunks"]) * int(self.cfg.get("eval", {}).get("chunk", 4096))
        self.tr.render_image(self.rays[0][0][:n], self.rays[0][1][:n])

    def render_window(self, seconds: float) -> dict:
        """``render_image`` over the cameras in turn, whole images, from one
        synchronize until the image that ends past ``seconds`` returns."""
        tr, n_cams = self.tr, len(self.rays)
        self.outputs, per_image, chunks, redo = {}, [], 0, 0
        failed, rays = 0, 0
        sync(self.device)
        t0 = time.perf_counter()
        k = 0
        while time.perf_counter() - t0 < seconds:
            cam = k % n_cams
            ti = time.perf_counter()
            colors, disp, _ = tr.render_image(*self.rays[cam])
            per_image.append(time.perf_counter() - ti)
            self.outputs[cam] = (colors, disp)
            n = self.rays[cam][0].shape[0]
            rays += n
            chunks += math.ceil(n / int(self.cfg.get("eval", {}).get("chunk", 4096)))
            redo += len(tr.last_redo)
            failed += int(not (np.isfinite(colors).all() and np.isfinite(disp).all()))
            k += 1
        sync(self.device)
        secs = time.perf_counter() - t0
        return dict(seconds=secs, images=k, rays=rays, failed=failed, chunks=chunks,
                    redo=redo, median_image_s=float(np.median(per_image)), t0=t0)

    def check_render(self, lower: bool = False) -> dict:
        """The reference renders a sample of the window's pixels, drawn from
        the seed, with capacities that never truncate. The numbers compared:
        color_gap, the mean absolute colour difference over the sample;
        disparity_gap, the mean absolute disparity difference over the mean
        disparity. The widest gaps go on an earlier line: a few rays whose
        last sample falls the other side of a cell or step boundary swing
        them from seed to seed."""
        dev = self.device
        m = self.mix
        rng = np.random.default_rng(self.seed)
        cams = sorted(self.outputs)
        pick = rng.choice(cams, size=min(int(m["check_images"]), len(cams)), replace=False)
        per = int(m["check_rays"]) // len(pick)
        params = to_device(self.render_params, dev)
        consts = {k: v.to(dev) for k, v in self.consts_host.items()}
        tree, mismatch = self.reference_tree(self.render_tree)
        st = ref.statics(self.cfg, per, False, int(m["check_max_s"]),
                         per * int(m["check_max_s"]), per * int(m["check_max_s"]),
                         self.step_key["hit_cap"], True)
        fine = ref.schedules.ray_march_fineness(self.render_iter, self.cfg["train"])
        dc, dd, d_ref, samples = [], [], [], 0.0
        ctx = ref.lower_precision() if lower else contextlib.nullcontext()
        with ctx:
            for cam in pick:
                colors, disp = self.outputs[int(cam)]
                idx = rng.choice(colors.shape[0], size=per, replace=False)
                ro, rd = (r[torch.as_tensor(idx, device=r.device)].to(dev)
                          for r in self.rays[int(cam)])
                c, d, n_s = ref.render_rays(params, consts, tree, ro, rd, fine, st)
                c, d = c.cpu().numpy(), d.cpu().numpy()
                dc.append(np.abs(colors[idx] - c))
                dd.append(np.abs(disp[idx] - d))
                d_ref.append(np.abs(d))
                samples += float(n_s)
        dc, dd, d_ref = (np.concatenate(x) for x in (dc, dd, d_ref))
        self.info["render_samples_per_ray"] = samples / (per * len(pick))
        self.info["check"] = dict(color_gap_widest=float(dc.max()),
                                  disparity_gap_widest=float(dd.max() / max(d_ref.max(), 1e-12)),
                                  rays_differing=int((dc.max(axis=1) > 0).sum()),
                                  rays=int(dc.shape[0]), cameras=[int(c) for c in pick],
                                  **self.info["tree"])
        return dict(color_gap=float(dc.mean()),
                    disparity_gap=float(dd.mean() / max(d_ref.mean(), 1e-12)),
                    tree_mismatch=mismatch)

    def keep_for_render_check(self) -> None:
        """What the render check needs once the program is freed."""
        tr = self.tr
        self.render_params = host_copy(tr.params)
        self.render_tree = host_copy(tree_fields(tr.tree))
        self.render_iter = tr.iter_step

    def free_program(self) -> None:
        self.tr = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _entries_differing(a, b) -> int:
    """Entries in which two tensors (bit for bit) or two numbers differ; a
    shape or type that differs counts every entry."""
    if not torch.is_tensor(b):
        return int(a != b)
    a = a.cpu()
    b = b.cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        return max(a.numel(), b.numel(), 1)
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def _leaves(tree):
    from .reference.tree import named_leaves
    return named_leaves(tree)


def _leaf_tensors(tree):
    return [t for _, t in _leaves(tree)]


def map_requires_grad(params):
    from .reference.tree import map_leaves
    return map_leaves(lambda t: t.detach().clone().contiguous().requires_grad_(True), params)


def _change_norms(params, start) -> dict:
    """{leaf: norm of (params - start)}, start on the host."""
    out = {}
    for (k, p), (_, p0) in zip(_leaves(params), _leaves(start)):
        out[k] = float(torch.linalg.vector_norm(p.detach().double().cpu() - p0.double()))
    return out


def _leaf_gaps(prog: dict, refn: dict, keep) -> dict:
    """Each kept leaf's gap of norms, |prog - ref| / max(ref, the median
    leaf's ref)."""
    keys = [k for k in refn if keep(k)]
    med = float(np.median([refn[k] for k in keys]))
    return {k: abs(prog[k] - refn[k]) / max(refn[k], med, 1e-30) for k in keys}


def compare_train(prog: dict, refr: dict, start: dict) -> tuple[dict, dict]:
    """The numbers compared for a training cell, and what else the check
    saw (for an earlier line):
    loss_gap: the first check step's loss, relative;
    grad_gap: the worst leaf's gap of the first gradient's norm, as Adam
      got it (its first moment after one step over 1 - b1), against the
      reference's norm of that leaf or of the median leaf;
    change_gap: the median leaf's gap of the parameters' change after the
      check steps, over the leaves whose reference gradient is at least a
      thousandth of the median leaf's (leaves below it move by round-off);
    fold_mismatch: the share of the occupancy entries (weight and alpha
      stats, visit counts, leaf rows) that differ after the check steps.
      A vote near its threshold flips on round-off, so a few entries may
      differ; a fold that never writes leaves every entry the reference's
      steps change (``fold_share_unwritten``, on the earlier line).
    The later steps' losses and the worst leaf's change go on the earlier
    line: Adam's update of an entry whose gradient is near zero is near
    +-lr whatever the gradient's size, so round-off flips them, and they
    swing from seed to seed where the first step's numbers do not.
    ``start``: the occupancy fields before the check steps."""
    losses = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], refr["losses"])]
    b1 = ref.ADAM_KW["b1"]
    g_p = {k: v / (1 - b1) for k, v in prog["mu"].items()}
    g_r = {k: v / (1 - b1) for k, v in refr["mu"].items()}
    grads = _leaf_gaps(g_p, g_r, lambda k: True)
    med_g = float(np.median(list(g_r.values())))
    change = _leaf_gaps(prog["change"], refr["change"], lambda k: g_r[k] >= 1e-3 * med_g)
    n_diff = sum(_entries_differing(prog["tree"][k], refr["tree"][k]) for k in FOLD_FIELDS)
    n_moved = sum(_entries_differing(start[k], refr["tree"][k]) for k in FOLD_FIELDS)
    n_all = sum(refr["tree"][k].numel() for k in FOLD_FIELDS)
    numbers = dict(loss_gap=float(losses[0]), grad_gap=float(max(grads.values())),
                   change_gap=float(np.median(list(change.values()))),
                   fold_mismatch=n_diff / n_all)
    seen = dict(loss_gaps=losses, change_gap_worst=max(change.values()),
                change_gaps=change, grad_gaps=grads, fold_entries_differing=n_diff,
                fold_share_unwritten=n_moved / n_all)
    return numbers, seen
