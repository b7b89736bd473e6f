"""Experiment runner: mode dispatch, eval rendering, artifact output (port of
``f2nerf_tpu/train/runner.py``; reference ExpRunner.{h,cpp}).

  * execute() dispatches on mode in {train, test, render_path, render_all}
    (ExpRunner.cpp:393-407);
  * train(): the loop with report/vis/stats/save cadences, stats.npy MSE
    history, train_info.txt wall time, final test_images()
    (ExpRunner.cpp:65-186), stepping through ``Trainer.train_auto`` with
    each chunk bounded by the next cadence, as the JAX Runner steps;
  * test_images(): whole-image renders of the test split, uint8-quantized
    PSNR and SSIM, color/depth/oct_depth PNGs, test_images/info.yaml and
    info.json (ExpRunner.cpp:343-391);
  * render_path(): novel_images/ renders along poses_render.npy
    (ExpRunner.cpp:322-341);
  * visualize_image(): 4-panel GT | pred | oct-depth | disparity PNGs
    (ExpRunner.cpp:301-320).

The config's ``reset`` flag re-initialises the field and shader after an
optional resume (``Trainer.reset``). ``F2_TORCH_PROFILE=<dir>`` traces
iterations 30-50 of ``train()`` with ``torch.profiler`` (host and CUDA)
and writes a chrome trace there: the counterpart of the JAX package's
``F2_JAX_PROFILE`` window. A chunk also ends at the window's edges, so
the trace holds exactly those iterations. The same iterations' host ms
by span (the span table of ``utils/spans.py``) are printed beside it.

Under data parallel (``torchrun``: one rank a shard) every rank trains;
rank 0 alone writes (train_info.txt, stats.npy, checkpoints, images/,
test_images/, novel_images/, the profile trace, cam_pos.ply, octree.obj)
and prints the reports, and the test, vis and path renders run on rank
0's card while the other ranks wait at a barrier after each, so all ranks
enter the next step's collectives together. (The JAX Runner writes from
every process.) A stop signal on any rank stops every rank at the same
chunk boundary.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time

import numpy as np
import yaml

from ..data import dataset as ds
from ..parallel import data_parallel as dp
from ..utils import io
from ..utils import spans as span_table
from ..utils.metrics import make_lpips, psnr_float, rgb_ssim
from .trainer import Trainer


class ProfileWindow:
    """A ``torch.profiler`` trace of training iterations [start, stop)
    written as ``<out_dir>/trace_<first>_<last>.json`` (chrome trace).
    Nothing happens without ``out_dir``. The trace also ends, and is
    written, when training stops inside the window. CUDA activity is
    traced where a card is present. The program's span table is collected
    over the same iterations, and its host ms an iteration by span printed
    at the close."""

    def __init__(self, out_dir: str | None, start: int = 30, stop: int = 50):
        self.out_dir, self.start, self.stop = out_dir, start, stop
        self.prof = None
        self.first = None
        self.was = self.table0 = None

    def at(self, it: int) -> None:
        """Called before iteration ``it``."""
        if not self.out_dir:
            return
        if self.prof is None and self.start <= it < self.stop:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
            self.prof = profile(activities=acts)
            self.was = span_table.collect(True)
            self.table0 = span_table.snapshot()
            self.prof.start()
            self.first = it
        elif self.prof is not None and it >= self.stop:
            self.close(it)

    def next_edge(self, it: int) -> int | None:
        """The first edge of the window (start or stop) after iteration
        ``it`` while a trace is still to be taken, else None: the Runner
        ends a chunk there, so ``at`` is called at both edges."""
        if not self.out_dir:
            return None
        return next((e for e in (self.start, self.stop) if e > it), None)

    def close(self, it: int) -> None:
        if self.prof is None:
            return
        self.prof.stop()
        table = span_table.diff(span_table.snapshot(), self.table0)
        span_table.collect(self.was)
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"trace_{self.first}_{it}.json")
        self.prof.export_chrome_trace(path)
        print(f"[profile] iterations {self.first}-{it} traced to {path}", flush=True)
        n = max(it - self.first, 1)
        rows = sorted(table.items(), key=lambda kv: -kv[1]["total_ns"])
        print("[profile] host ms an iteration by span (total, self, entries; held by): "
              + json.dumps(
                  {k: [round(v["total_ns"] / 1e6 / n, 3), round(v["self_ns"] / 1e6 / n, 3),
                       v["count"], v["parent"]] for k, v in rows}), flush=True)
        self.prof, self.out_dir = None, None


class Runner:
    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.base_exp_dir = cfg["base_exp_dir"]
        data_path = cfg["dataset"]["data_path"]

        t0 = time.time()
        self.trainer = Trainer(cfg, self.base_exp_dir, data_path,
                               device=cfg.get("device", "cuda"))
        if self.lead:
            print(f"Trainer built in {time.time() - t0:.1f}s", flush=True)
            io.export_pcd(os.path.join(self.base_exp_dir, "cam_pos.ply"),
                          self.trainer.dataset.poses[:, :3, 3])
            io.export_octree_obj(os.path.join(self.base_exp_dir, "octree.obj"),
                                 self.trainer.tree_host)

        if cfg.get("is_continue"):
            self.trainer.load_checkpoint()
        if cfg.get("reset"):
            self.trainer.reset()

        t = cfg["train"]
        self.end_iter = int(t["end_iter"])
        self.report_freq = int(t["report_freq"])
        self.vis_freq = int(t["vis_freq"])
        self.stats_freq = int(t["stats_freq"])
        self.save_freq = int(t["save_freq"])

    @property
    def lead(self) -> bool:
        """Rank 0 (or no process group): the rank that writes and renders."""
        return dp.world()[0] == 0

    # ------------------------------------------------------------------ modes

    def execute(self):
        mode = self.cfg["mode"]
        if mode == "train":
            self.train()
        elif mode == "test":
            self._lead_renders(self.test_images)
        elif mode == "render_path":
            self._lead_renders(self.render_path)
        elif mode == "render_all":
            self._lead_renders(self.render_all_images)
        else:
            raise ValueError(f"Unknown mode {mode!r}")

    def _lead_renders(self, fn, *args):
        """``fn`` on rank 0 alone; every rank then meets at a barrier
        (nothing to wait for without a process group). Returns fn's result
        on rank 0, None elsewhere."""
        out = None
        try:
            if self.lead:
                out = fn(*args)
        finally:
            dp.barrier()
        return out

    def train(self):
        tr = self.trainer
        t_start = time.time()
        # Graceful preemption: SIGTERM/SIGINT finish the current chunk,
        # save the exact state, then run the end-of-train flow (test render
        # + train_info) instead of dying mid-step. The reference has no
        # equivalent (ExpRunner.cpp:180-186 saves only at end_iter).
        stop_sig = {"n": None}
        prev_handlers = {}
        # signal.signal raises off the main thread; skip the graceful-stop
        # hook there (a worker-thread train() still trains, just without it)
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[sig] = signal.signal(
                    sig, lambda n, f: stop_sig.__setitem__("n", n))
        prof = ProfileWindow(os.environ.get("F2_TORCH_PROFILE") if self.lead else None)
        try:
            self._train_loop(tr, stop_sig, time.time(), prof)
        finally:
            prof.close(tr.iter_step)
            # an exception mid-loop must not leave the swallow-and-flag
            # handlers installed (later SIGINT/SIGTERM would be ignored)
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)
        stopped = tr.iter_step < self.end_iter
        if stopped and self.lead:
            print(f"Graceful stop (signal {stop_sig['n']}) at iter "
                  f"{tr.iter_step}; saving state.", flush=True)
        # final state must always be on disk, whether or not end_iter lands
        # on the save cadence
        if stopped or self.end_iter % self.save_freq != 0:
            tr.save_checkpoint()
        if self.lead:
            with open(os.path.join(self.base_exp_dir, "train_info.txt"), "w") as f:
                f.write(f"{time.time() - t_start}\n")
            print("Train done, test.", flush=True)
        self._lead_renders(self.test_images)

    def _train_loop(self, tr, stop_sig, t_report, prof):
        freqs = [self.report_freq, self.vis_freq, self.stats_freq, self.save_freq]
        # a signal may reach the ranks at different steps: they agree on it
        # before each chunk, so all of them leave the loop together
        while tr.iter_step < self.end_iter and \
                not dp.any_rank(stop_sig["n"] is not None):
            s = tr.iter_step
            prof.at(s)
            # distance to the next report/vis/stats/save cadence bounds the
            # chunk so `step % freq` checks still land exactly; the last
            # step before a cadence is fetched at once (sync)
            nb = min([(s // f + 1) * f for f in freqs] + [self.end_iter])
            edge = prof.next_edge(s)
            if edge is not None:
                nb = min(nb, edge)
            limit = nb - s
            m = tr.train_auto(sync=limit <= tr.chunk_size, limit=limit)
            step = tr.iter_step
            if step % self.stats_freq == 0 and self.lead:
                np.save(os.path.join(self.base_exp_dir, "stats.npy"),
                        np.asarray(tr.mse_records, np.float32))
            # checkpoint BEFORE the vis render: the vis is the riskiest call
            # at a cadence step (fresh eval shapes, the biggest buffers)
            if step % self.save_freq == 0:
                tr.save_checkpoint()
            if step % self.vis_freq == 0 and len(tr.dataset.test_set):
                vis_idx = int(tr.dataset.test_set[
                    (step // self.vis_freq) % len(tr.dataset.test_set)])
                self._lead_renders(self._vis, vis_idx, step)
            if m and step % self.report_freq == 0 and self.lead:
                ips = self.report_freq / max(time.time() - t_report, 1e-6)
                t_report = time.time()
                trunc = (f" TravTrunc: {tr.trunc_ema:.2f}"
                         if tr.trunc_ema > 0.005 else "")
                trunc += (f" SampleSat: {tr.sat_ema:.2f}"
                          if getattr(tr, "sat_ema", 0.0) > 0.005 else "")
                trunc += (f" GradTrunc: {tr.b_trunc_ema:.2f}"
                          if getattr(tr, "b_trunc_ema", 0.0) > 0.005 else "")
                print(f"Iter: {step:>6d} PSNR: {tr.psnr_smooth:.2f} "
                      f"NRays: {m['n_rays']:>5d} OctSamples: {tr.ema_oct:.1f} "
                      f"Samples: {tr.ema_sampled:.1f} "
                      f"MeaningfulSamples: {tr.ema_meaningful:.1f} "
                      f"IPS: {ips:.2f}{trunc}", flush=True)

    def _vis(self, vis_idx: int, step: int):
        try:
            t_vis = time.time()
            self.visualize_image(vis_idx)
            print(f"[vis] image {vis_idx} rendered in "
                  f"{time.time() - t_vis:.1f}s", flush=True)
        except Exception as e:  # noqa: BLE001
            # a vis render must never kill a long training run (e.g.
            # an eval-capacity OOM at an unlucky tree state);
            # training state is untouched — log and continue
            print(f"[vis] render failed at iter {step}: {e!r} "
                  "(training continues)", flush=True)

    # ------------------------------------------------------------- rendering

    def _render_camera(self, idx: int):
        tr = self.trainer
        ro, rd = ds.camera_rays(tr.data, idx, tr.dataset.height, tr.dataset.width)
        return tr.render_image(ro, rd)

    def _finalize_disp(self, colors, disp, oct_d, h, w):
        disp = disp / max(float(disp.max()), 1e-9)
        oct_d = float(oct_d.min()) / np.maximum(oct_d, 1e-9)
        return (colors.reshape(h, w, 3), disp.reshape(h, w, 1),
                oct_d.reshape(h, w, 1))

    def visualize_image(self, idx: int):
        tr = self.trainer
        h, w = tr.dataset.height, tr.dataset.width
        colors, disp, oct_d = self._render_camera(idx)
        colors, disp, oct_d = self._finalize_disp(colors, disp, oct_d, h, w)
        gt = tr.dataset.images[idx].astype(np.float32) / 255.0
        panel = np.concatenate(
            [gt, colors, np.repeat(oct_d, 3, -1), np.repeat(disp, 3, -1)], axis=1)
        io.write_image(os.path.join(self.base_exp_dir, "images",
                                    f"{tr.iter_step}_{idx}.png"), panel)

    def test_images(self):
        tr = self.trainer
        h, w = tr.dataset.height, tr.dataset.width
        out_dir = os.path.join(self.base_exp_dir, "test_images")
        os.makedirs(out_dir, exist_ok=True)
        lpips_fn = make_lpips()   # None without the lpips package
        info = {}
        full = {"psnr": {}, "ssim": {}, "lpips": {}}
        psnrs, ssims, lpipss = [], [], []
        for idx in map(int, tr.dataset.test_set):
            t_img = time.time()
            colors, disp, oct_d = self._render_camera(idx)
            colors, disp, oct_d = self._finalize_disp(colors, disp, oct_d, h, w)
            # quantize before PSNR (ExpRunner.cpp:349-369)
            pred = np.round(np.clip(colors, 0, 1) * 255.0) / 255.0
            gt = tr.dataset.images[idx].astype(np.float32) / 255.0
            psnr = psnr_float(gt, pred)
            ssim = rgb_ssim(gt, pred)
            info[str(idx)] = float(psnr)
            full["psnr"][str(idx)] = float(psnr)
            full["ssim"][str(idx)] = float(ssim)
            psnrs.append(psnr)
            ssims.append(ssim)
            if lpips_fn is not None:
                lp = lpips_fn((gt * 255).astype(np.float32),
                              (pred * 255).astype(np.float32))
                full["lpips"][str(idx)] = lp
                lpipss.append(lp)
            print(f"{idx}: psnr {psnr:.3f} ssim {ssim:.4f} "
                  f"({time.time() - t_img:.1f}s)", flush=True)
            step = tr.iter_step
            io.write_image(os.path.join(out_dir, f"color_{step}_{idx:03d}.png"), pred)
            io.write_image(os.path.join(out_dir, f"depth_{step}_{idx:03d}.png"),
                           np.repeat(disp, 3, -1))
            io.write_image(os.path.join(out_dir, f"oct_depth_{step}_{idx:03d}.png"),
                           np.repeat(oct_d, 3, -1))
        info["mean_psnr"] = float(np.mean(psnrs)) if psnrs else 0.0
        full["psnr"]["mean"] = info["mean_psnr"]
        full["ssim"]["mean"] = float(np.mean(ssims)) if ssims else 0.0
        full["lpips"]["mean"] = float(np.mean(lpipss)) if lpipss else None
        print(f"Mean psnr: {info['mean_psnr']} "
              f"mean ssim: {full['ssim']['mean']:.4f}", flush=True)
        with open(os.path.join(out_dir, "info.yaml"), "w") as f:
            yaml.safe_dump(info, f)
        with open(os.path.join(out_dir, "info.json"), "w") as f:
            json.dump(full, f, indent=2)
        return info

    def render_path(self, reso_level: int = 1):
        tr = self.trainer
        poses = tr.dataset.render_poses
        if poses is None:
            raise FileNotFoundError("poses_render.npy not found in dataset")
        # optional frame cap (override: +render_path_frames=N)
        n_cap = int(self.cfg.get("render_path_frames") or 0)
        if n_cap > 0:
            poses = poses[:n_cap]
        h = tr.dataset.height // reso_level
        w = tr.dataset.width // reso_level
        for i in range(poses.shape[0]):
            ro, rd = ds.pose_rays(tr.data, poses[i], tr.dataset.height,
                                  tr.dataset.width, reso_level)
            colors, disp, oct_d = tr.render_image(ro, rd)
            colors, disp, oct_d = self._finalize_disp(colors, disp, oct_d, h, w)
            panel = np.concatenate(
                [colors, np.repeat(oct_d, 3, -1), np.repeat(disp, 3, -1)], axis=1)
            io.write_image(os.path.join(self.base_exp_dir, "novel_images",
                                        f"{tr.iter_step}_{i:03d}.png"), panel)
            print(i, flush=True)

    def render_all_images(self):
        for idx in range(self.trainer.dataset.n_images):
            self.visualize_image(idx)
