"""Data-parallel training over torch.distributed (port of
``f2nerf_tpu/parallel/data_parallel.py``).

The JAX package shards one 1-D ``'data'`` mesh over the devices of one
process (or, multi-host, of several) and runs the step under
``shard_map``. PyTorch's idiom is one process per card, so here a
torch.distributed rank IS a shard: the world size is the shard count and
the rank the shard index. Each rank drives ``cuda:LOCAL_RANK``; several
hosts are the same code under ``torchrun --nnodes``.

  * Each rank holds its own block of the camera pool (``shard_rows``: the
    train ids padded with the leading ones to a multiple of the world
    size, then contiguous blocks, as ``Dataset.device_arrays(n_shards)``
    followed by ``shard_data`` lays them out in the JAX package) and draws
    its rays from its own cameras with its own random stream.
  * Parameters, the octree and the hash pool are replicated. The step's
    reductions are the JAX step's (trainer.py:355-363): gradients
    all-reduced and divided by the world size (``pmean``), occupancy votes
    MAX (``pmax``), count stats SUM except ``max_oct_hits`` (MAX), loss
    scalars mean. ``reduce_step`` packs them into two collectives.
  * The optimizer runs on every rank on identical inputs, so parameters
    stay bitwise replicated, and every host-side controller decision reads
    only reduced values: all ranks walk the same buckets, caps and hit
    caps with no control channel.

Only ``all_reduce``, ``broadcast`` and ``barrier`` are used: gloo (the CPU
backend, and the one that lets two ranks share one card) does not
``all_gather`` CUDA tensors.
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as tdist

from ..utils.tree import map_leaves, named_leaves

# a dead rank leaves its peers blocked in a collective; they give up after
# this long instead of hanging for torch's default half hour
TIMEOUT_S = 600.0


def init_distributed(backend: str | None = None, init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     timeout_s: float = TIMEOUT_S) -> None:
    """Join the process group. With no arguments, torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``) describes
    it. The backend is NCCL when a CUDA card is present and gloo
    otherwise, unless one is named; with NCCL the current device becomes
    ``cuda:LOCAL_RANK`` first."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank or 0)))
    kw = {}
    if world_size is not None:
        kw["world_size"] = int(world_size)
    if rank is not None:
        kw["rank"] = int(rank)
    tdist.init_process_group(backend=backend, init_method=init_method,
                             timeout=timedelta(seconds=timeout_s), **kw)


def initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def world() -> tuple[int, int]:
    """(rank, world size); (0, 1) when no process group is initialized."""
    if initialized():
        return tdist.get_rank(), tdist.get_world_size()
    return 0, 1


def data_parallel_shards(dp_cfg, world_size: int) -> int:
    """The shard count ``train.data_parallel`` asks for, checked against
    the world size: 'auto'/'on'/true mean the world size; 'off'/false mean
    1 and an int pins the count, and either must equal the world size.
    Unlike the JAX package, whose 'auto' shards over every local device of
    one process, the shards here are the ranks that torchrun started."""
    if isinstance(dp_cfg, str):
        dp_cfg = dp_cfg.strip().lower()
    if dp_cfg in ("auto", "on", None, True):     # YAML: on -> True
        return world_size
    if dp_cfg in ("off", "none", False):         # YAML: off -> False
        want = 1
    else:
        want = int(dp_cfg)
    if want != world_size:
        raise ValueError(
            f"train.data_parallel={dp_cfg!r} asks for {want} shard(s), but "
            f"{world_size} process(es) run: a shard is a torch.distributed "
            f"rank, so start {want} with `torchrun --nproc_per_node={want} "
            f"-m f2nerf_torch.run ...` (or set train.data_parallel=auto)")
    return want


def shard_rows(n_train: int, n_shards: int, shard: int) -> np.ndarray:
    """Positions in the train set of one shard's camera rows: the train
    ids padded with the leading ones to a multiple of ``n_shards``, then
    contiguous blocks (JAX dataset.py:120-123 and ``shard_data``). The
    padding repeats cameras, so with shards << cameras the duplicate
    sampling bias is negligible."""
    if not 0 <= shard < n_shards:
        raise ValueError(f"shard {shard} outside [0, {n_shards})")
    per = -(-n_train // n_shards)
    return np.arange(shard * per, (shard + 1) * per) % n_train


def process_camera_slice(n_images: int) -> np.ndarray:
    """The camera rows this process loads: its shard's rows by the one
    padded rule (``shard_rows``). The JAX helper of this name divides the
    unpadded count and so disagrees with its own Trainer wherever the
    count is not a multiple of the process count."""
    rank, size = world()
    return shard_rows(n_images, size, rank)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s draw stream: rank 0 keeps ``seed`` (a
    one-rank run draws as the single-device trainer does); the others get
    streams of their own (JAX folds the shard index into the step key)."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)[0])


def reduce_step(grads: dict, aux: dict, stats: dict, occ: dict):
    """One step's cross-rank reductions in two collectives: a SUM over the
    flat gradients, the loss scalars and the count stats (gradients and
    losses then divided by the world size: ``pmean``), and a MAX over the
    occupancy votes and ``max_oct_hits`` (integral, so exact as int32).
    Returns (grads, aux, stats, occ) reduced; the gradients are views of
    one buffer."""
    n = tdist.get_world_size()
    leaves = []
    map_leaves(leaves.append, grads)
    sum_stats = [k for k in stats if k != "max_oct_hits"]
    flat = torch.cat([g.reshape(-1) for g in leaves]
                     + [aux[k].reshape(1).to(torch.float32) for k in aux]
                     + [stats[k].reshape(1) for k in sum_stats])
    tdist.all_reduce(flat, op=tdist.ReduceOp.SUM)
    n_grad = sum(g.numel() for g in leaves)
    n_mean = n_grad + len(aux)
    flat[:n_mean] = flat[:n_mean] / n
    chunks = iter(torch.split(flat[:n_grad], [g.numel() for g in leaves]))
    out_grads = map_leaves(lambda g: next(chunks).view(g.shape), grads)
    out_aux = dict(zip(aux, flat[n_grad:n_mean]))
    out_stats = dict(zip(sum_stats, flat[n_mean:]))

    votes = torch.cat([occ[k].reshape(-1) for k in occ]
                      + [stats["max_oct_hits"].reshape(1).to(torch.int32)])
    tdist.all_reduce(votes, op=tdist.ReduceOp.MAX)
    out_occ = dict(zip(occ, torch.split(votes[:-1], [occ[k].numel() for k in occ])))
    out_stats["max_oct_hits"] = votes[-1].to(torch.float32)
    return out_grads, out_aux, {k: out_stats[k] for k in stats}, out_occ


def broadcast_params(params: dict) -> None:
    """Overwrite every rank's params with rank 0's, in place (after a
    draw that only rank 0's stream defines, e.g. ``Trainer.reset``)."""
    with torch.no_grad():
        for _, p in named_leaves(params):
            tdist.broadcast(p.data, src=0)


def barrier() -> None:
    """Wait for every rank; nothing without a process group."""
    if initialized():
        tdist.barrier()


def any_rank(flag: bool) -> bool:
    """True when ``flag`` holds on some rank (a MAX all-reduce); the flag
    itself without a process group."""
    if not initialized():
        return flag
    dev = torch.cuda.current_device() if tdist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([int(flag)], dtype=torch.int32, device=dev)
    tdist.all_reduce(t, op=tdist.ReduceOp.MAX)
    return bool(t.item())
