"""Segmented (per-ray) ops over flat sample buffers (port of
``f2nerf_tpu/ops/segment.py``).

Samples sit in a flat fixed-capacity buffer with a per-sample ``ray_id``
(sorted; padding rows carry ray_id == n_rays). The differentiable ops are
``torch.autograd.Function``s whose sums are taken in a fixed order, so a
step on the card gives the same bits on every run:

  * ``segment_sum`` (``SegmentSum``): per-ray sums; kernel K10
    (``segment_reduce``), backward the gather of each ray's gradient to its
    samples (zeros on padding);
  * ``segment_cumsum`` (``SegmentCumsum``): the segmented prefix sum;
    kernel K11 (``segment_scan``, one launch a call), backward K11 in
    reverse over the same segments;
  * ``ray_gather`` (``RayGather``): ``x[ray_id]`` for x [n_rays, ...],
    zeros on padding; backward K10;
  * ``local_index``: each sample's index in its ray (``ray_offsets``);
  * ``ray_offsets``: each ray's first row, its count, each row's local
    index and first flag, one launch a buffer; given the buffer's offsets
    (from the kernel that made the buffer), the rest in one plain launch.
    K10 reads the offsets instead of searching ``ray_id``: ``segment_sum``,
    ``ray_gather`` and ``segment_reduce`` take them as an optional last
    argument (computed when not given). The renderer's B buffer comes with
    all four from K13 (render/renderer.py ``compact_keep``); the
    single-pass B, which is A, takes K12's offsets.

K10, K11 and the offsets launch are in csrc/segment.cu. A wrapper given
CPU tensors runs its plain version (``segment_sum_plain``: an index_add;
``segment_cumsum_plain``: a float64 global cumsum minus each segment's
base, found with cummax; ``ray_offsets_plain``: a searchsorted); given
CUDA tensors it launches its kernel or raises. Both scans accumulate in
float64: a global f32 cumsum minus each segment's base would lose
precision over a 393k-sample buffer, which is why the JAX package scans
(value, flag) pairs instead.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..utils.spans import span


# ------------------------------------------------------------ plain versions

def segment_sum_plain(x: torch.Tensor, ray_id: torch.Tensor, n_rays: int) -> torch.Tensor:
    """Per-ray sum. x: [cap] or [cap, c]; returns [n_rays] or [n_rays, c].
    Padding samples (ray_id == n_rays) are dropped."""
    out = x.new_zeros((n_rays + 1,) + tuple(x.shape[1:]))
    return out.index_add(0, ray_id.long(), x)[:n_rays]


def _segment_start(is_first: torch.Tensor) -> torch.Tensor:
    """Index of the latest flagged position <= k (0 before any flag), the
    reset point of the JAX (value, flag) scan."""
    idx = torch.arange(is_first.shape[0], device=is_first.device)
    marks = torch.where(is_first, idx, torch.zeros_like(idx))
    return torch.cummax(marks, dim=0).values


def segment_cumsum_plain(x: torch.Tensor, is_first: torch.Tensor,
                         exclusive: bool = True, reverse: bool = False) -> torch.Tensor:
    """Segmented prefix sum along a flat buffer (FlexOps::AccumulateSum,
    FlexOps.cu:75-215). ``is_first`` marks the first sample of each
    segment; rows after the last flag keep accumulating (as in the JAX
    scan). ``reverse``: each segment's suffix sums (the same segments read
    from the end, where a segment's last row starts it)."""
    if reverse:
        last = torch.ones_like(is_first)
        last[:-1] = is_first[1:]
        return segment_cumsum_plain(x.flip(0), last.flip(0), exclusive).flip(0)
    cs = torch.cumsum(x.double(), dim=0)
    cs_pad = torch.cat([cs.new_zeros(1), cs])
    base = cs_pad.index_select(0, _segment_start(is_first))
    if exclusive:
        return (cs_pad[:-1] - base).to(x.dtype)
    return (cs - base).to(x.dtype)


def local_index_plain(ray_id: torch.Tensor, n_rays: int) -> torch.Tensor:
    """Index of each sample within its ray (0-based), int32."""
    return _local_from_first(first_flags_from_ray_id(ray_id, n_rays))


def _local_from_first(is_first: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(is_first.shape[0], device=is_first.device)
    return (idx - _segment_start(is_first)).to(torch.int32)


def ray_offsets_plain(ray_id: torch.Tensor, n_rays: int):
    """Plain version of ``ray_offsets`` (both forms: given offsets must be
    these): a searchsorted over the sorted ray_id, the differences of the
    offsets, ``local_index_plain`` and ``first_flags_from_ray_id``."""
    keys = torch.arange(n_rays + 1, dtype=ray_id.dtype, device=ray_id.device)
    offsets = torch.searchsorted(ray_id, keys).to(torch.int32)
    counts = (offsets[1:] - offsets[:-1]).to(torch.float32)
    first = first_flags_from_ray_id(ray_id, n_rays)
    return offsets, counts, _local_from_first(first), first


# ------------------------------------------------------------------ kernels

def _check_cuda(name: str, x: torch.Tensor, other: torch.Tensor, other_dtype) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.float32 or other.dtype != other_dtype \
            or other.dim() != 1 or x.shape[:1] != other.shape:
        raise ValueError(f"{name}: expected float32 x [n, ...] and {other_dtype} [n], "
                         f"got {x.dtype} {tuple(x.shape)} and {other.dtype} "
                         f"{tuple(other.shape)}")


def check_offsets(name: str, offsets, ray_id: torch.Tensor, n_rays: int) -> None:
    """``offsets`` as ``ray_offsets`` gives them for (ray_id, n_rays): int32
    [n_rays + 1] on ray_id's device."""
    if not torch.is_tensor(offsets) or offsets.dtype != torch.int32 \
            or tuple(offsets.shape) != (n_rays + 1,) or offsets.device != ray_id.device:
        got = (f"{offsets.dtype} {tuple(offsets.shape)} on {offsets.device}"
               if torch.is_tensor(offsets) else type(offsets).__name__)
        raise ValueError(f"{name}: offsets must be int32 [{n_rays + 1}] on "
                         f"{ray_id.device}, got {got}")


def ray_offsets(ray_id: torch.Tensor, n_rays: int, offsets: torch.Tensor | None = None):
    """Each ray's rows in a ray-sorted buffer (int32 ray_id [n], padding
    rows == n_rays): offsets [n_rays + 1] int32 (each ray's first row,
    offsets[n_rays] the first padding row, n if none), counts [n_rays] f32
    (its rows), local_index [n] int32 (``local_index``'s values: padding
    rows continue the last ray's count) and first [n] bool
    (``first_flags_from_ray_id``). ``offsets``: the buffer's offsets, as
    the kernel that made it wrote them (K12's for buffer A); then they are
    returned as given and the launch writes the rest. CPU tensors take
    ``ray_offsets_plain``; CUDA tensors launch one kernel (csrc/segment.cu):
    without offsets a cooperative one, a thread a row, with them a plain
    one, a thread a row or ray."""
    if ray_id.dtype != torch.int32 or ray_id.dim() != 1 or n_rays < 0:
        raise ValueError(f"ray_offsets: expected int32 ray_id [n] and n_rays >= 0, got "
                         f"{ray_id.dtype} {tuple(ray_id.shape)}, n_rays {n_rays}")
    if offsets is not None:
        check_offsets("ray_offsets", offsets, ray_id, n_rays)
    if ray_id.device.type == "cpu":
        return ray_offsets_plain(ray_id, n_rays)
    if ray_id.device.type != "cuda":
        raise ValueError(f"ray_offsets: unsupported device {ray_id.device}")
    ray_id = ray_id.contiguous()
    kernels.require_cuda("ray_offsets", ray_id, *(() if offsets is None else (offsets,)))
    n = ray_id.shape[0]
    dev = ray_id.device
    i32 = dict(dtype=torch.int32, device=dev)
    counts = torch.empty((n_rays,), dtype=torch.float32, device=dev)
    local = torch.empty((n,), **i32)
    first = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return (torch.zeros((n_rays + 1,), **i32) if offsets is None else offsets,
                counts.zero_(), local, first)
    given = offsets is not None
    if not given:
        offsets = torch.empty((n_rays + 1,), **i32)
    code = kernels.library().f2_ray_offsets(
        ray_id.data_ptr(), offsets.data_ptr(), counts.data_ptr(), local.data_ptr(),
        first.data_ptr(), n, n_rays, int(given), kernels.stream_ptr(dev))
    kernels.check(code, "ray_offsets")
    ray_offsets.launches += 1
    if given:
        ray_offsets.given_launches += 1
    return offsets, counts, local, first


ray_offsets.launches = 0
ray_offsets.given_launches = 0    # of them, the given form


def segment_reduce(x: torch.Tensor, ray_id: torch.Tensor, n_rays: int,
                   offsets: torch.Tensor | None = None) -> torch.Tensor:
    """Per-ray sums of x [cap] or [cap, c] over a ray-sorted buffer (int32
    ray_id, padding rows dropped): [n_rays] or [n_rays, c]. ``offsets``:
    ``ray_offsets``' first output for this ray_id (computed when None). CPU
    tensors take ``segment_sum_plain``; CUDA tensors launch K10, one warp a
    ray over its rows [offsets[r], offsets[r + 1]) (held to x's rows: offsets
    of another buffer never read past x's end), all channels in one
    pass (float4 quads where c is 4, 8, 16 or 32), then a fixed xor tree,
    so every channel's sum has the same order on every run."""
    if offsets is not None:
        check_offsets("segment_reduce", offsets, ray_id, n_rays)
    if x.device.type == "cpu":
        return segment_sum_plain(x, ray_id, n_rays)
    _check_cuda("segment_reduce", x, ray_id, torch.int32)
    if x.dim() not in (1, 2):
        raise ValueError(f"segment_reduce: x must be [cap] or [cap, c], got {tuple(x.shape)}")
    c = 1 if x.dim() == 1 else x.shape[1]
    # rows of c unit-stride floats are read in place (a column slice of a
    # wider buffer, as the appearance gather's gradient is); others copied
    if x.stride(-1) != 1 or (x.dim() == 2 and x.shape[0] > 1 and x.stride(0) < c):
        x = x.contiguous()
    ld = c if x.dim() == 1 or x.shape[0] <= 1 else x.stride(0)
    if offsets is None:
        offsets = ray_offsets(ray_id, n_rays)[0]
    kernels.require_cuda("segment_reduce", offsets)
    if x.device != offsets.device:
        raise ValueError(f"segment_reduce: x on {x.device}, offsets on {offsets.device}")
    out = torch.empty((n_rays,) + tuple(x.shape[1:]), dtype=torch.float32, device=x.device)
    if n_rays == 0 or c == 0:
        return out
    code = kernels.library().f2_segment_reduce(
        x.data_ptr(), ld, x.shape[0], offsets.data_ptr(), out.data_ptr(), n_rays, c,
        kernels.stream_ptr(x.device))
    kernels.check(code, "segment_reduce")
    segment_reduce.launches += 1
    return out


segment_reduce.launches = 0

SCAN_TILE_ROWS = 2048     # csrc/segment.cu kTileRows: rows a block of K11 scans
SCAN_TILE_BYTES = 16      # a tile's published aggregate (and the counters' slot)
_scan_states: dict = {}


def scan_state_bytes(n: int) -> int:
    """Bytes of K11's state for n rows: the ticket and done counters (one
    16-byte slot), then one 16-byte aggregate a tile of SCAN_TILE_ROWS."""
    return SCAN_TILE_BYTES * (1 + -(-n // SCAN_TILE_ROWS))


def scan_state(device, stream: int, n: int) -> torch.Tensor:
    """K11's state for n rows on (device, stream): a uint8 buffer, zeroed
    once when allocated; every launch leaves it zero again (its last block
    resets the counters and flags), so it is kept and reused, one a device
    and stream (launches on one stream run in order). It grows to the next
    power of two of bytes when a call needs more."""
    return zeroed_state(_scan_states, device, stream, scan_state_bytes(n))


def zeroed_state(states: dict, device, stream: int, need: int) -> torch.Tensor:
    """A kernel's state buffer of at least ``need`` bytes on (device,
    stream) from ``states`` (``scan_state``'s rules: zeroed when allocated,
    left zero by every launch, grown to a power of two)."""
    key = (str(device), stream)
    st = states.get(key)
    if st is None or st.numel() < need:
        st = torch.zeros((1 << (need - 1).bit_length(),), dtype=torch.uint8, device=device)
        states[key] = st
    return st


def check_state_launch(code: int, name: str, states: dict, device, stream: int) -> None:
    """``kernels.check`` for a launch that takes a ``zeroed_state`` buffer:
    after a failed launch the buffer is dropped from ``states`` (the
    launch may have left its flags and counters set), so the next call
    starts from a new zeroed one and fails, if it does, as an error and
    not as a wait that never ends."""
    if code != 0:
        states.pop((str(device), stream), None)
    kernels.check(code, name)


def segment_scan(x: torch.Tensor, is_first: torch.Tensor, exclusive: bool = True,
                 reverse: bool = False) -> torch.Tensor:
    """Segmented prefix sum of x [cap] (``segment_cumsum_plain``'s function:
    segments start at ``is_first`` [cap] bool, exclusive or inclusive,
    forward or reverse), summed in float64. CPU tensors take
    ``segment_cumsum_plain``; CUDA tensors launch K11 (one launch: a block a
    tile of SCAN_TILE_ROWS rows, each tile's carry from the earlier tiles'
    published aggregates in a fixed order)."""
    if x.device.type == "cpu":
        return segment_cumsum_plain(x, is_first, exclusive, reverse)
    _check_cuda("segment_scan", x, is_first, torch.bool)
    if x.dim() != 1:
        raise ValueError(f"segment_scan: x must be [cap], got {tuple(x.shape)}")
    x, is_first = x.contiguous(), is_first.contiguous()
    kernels.require_cuda("segment_scan", x, is_first)
    n = x.shape[0]
    out = torch.empty_like(x)
    if n == 0:
        return out
    stream = kernels.stream_ptr(x.device)
    state = scan_state(x.device, stream, n)
    code = kernels.library().f2_segment_scan(
        x.data_ptr(), is_first.data_ptr(), out.data_ptr(), state.data_ptr(), n,
        int(exclusive), int(reverse), stream)
    check_state_launch(code, "segment_scan", _scan_states, x.device, stream)
    segment_scan.launches += 1
    return out


segment_scan.launches = 0


# ------------------------------------------------------ differentiable ops

def _gather_rows(x: torch.Tensor, ray_id: torch.Tensor) -> torch.Tensor:
    """Rows ``ray_id`` of x [n_rays, ...], zeros where ray_id == n_rays."""
    pad = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    return pad.index_select(0, ray_id)


class SegmentSum(torch.autograd.Function):
    """Per-ray sums (K10); backward gathers each ray's gradient to its
    samples, zeros on padding."""

    @staticmethod
    def forward(ctx, x, ray_id, n_rays, offsets=None):
        ctx.save_for_backward(ray_id)
        return segment_reduce(x, ray_id, n_rays, offsets)

    @staticmethod
    def backward(ctx, g):
        with span("backward.segment"):
            (ray_id,) = ctx.saved_tensors
            return _gather_rows(g, ray_id), None, None, None


class SegmentCumsum(torch.autograd.Function):
    """Segmented prefix sum (K11); backward is K11 in reverse over the same
    segments."""

    @staticmethod
    def forward(ctx, x, is_first, exclusive):
        ctx.save_for_backward(is_first)
        ctx.exclusive = exclusive
        return segment_scan(x, is_first, exclusive, False)

    @staticmethod
    def backward(ctx, g):
        with span("backward.segment"):
            (is_first,) = ctx.saved_tensors
            return segment_scan(g, is_first, ctx.exclusive, True), None, None


class RayGather(torch.autograd.Function):
    """``x[ray_id]`` over a ray-sorted buffer, zeros on padding; backward is
    K10 (each ray's rows summed in a fixed order)."""

    @staticmethod
    def forward(ctx, x, ray_id, n_rays, offsets=None):
        ctx.save_for_backward(ray_id, offsets)
        ctx.n_rays = n_rays
        return _gather_rows(x, ray_id)

    @staticmethod
    def backward(ctx, g):
        with span("backward.segment"):
            ray_id, offsets = ctx.saved_tensors
            return segment_reduce(g, ray_id, ctx.n_rays, offsets), None, None, None


def segment_sum(x: torch.Tensor, ray_id: torch.Tensor, n_rays: int,
                offsets: torch.Tensor | None = None) -> torch.Tensor:
    """Per-ray sum. x: [cap] or [cap, c]; returns [n_rays] or [n_rays, c].
    Padding samples (ray_id == n_rays) are dropped. ``offsets``:
    ``ray_offsets(ray_id, n_rays)[0]``, computed on the card when None."""
    return SegmentSum.apply(x, ray_id, n_rays, offsets)


def segment_cumsum(x: torch.Tensor, is_first: torch.Tensor,
                   exclusive: bool = True) -> torch.Tensor:
    """Segmented prefix sum along a flat buffer (``segment_cumsum_plain``'s
    function, JAX's ``segment_cumsum``)."""
    return SegmentCumsum.apply(x, is_first, exclusive)


def ray_gather(x: torch.Tensor, ray_id: torch.Tensor, n_rays: int,
               offsets: torch.Tensor | None = None) -> torch.Tensor:
    """Each sample's row of the per-ray x [n_rays, ...]; zeros on padding.
    ``offsets`` as ``segment_sum`` takes them (its backward's K10)."""
    if offsets is not None:
        check_offsets("ray_gather", offsets, ray_id, n_rays)
    return RayGather.apply(x, ray_id, n_rays, offsets)


def segment_max(x: torch.Tensor, ray_id: torch.Tensor, n_rays: int) -> torch.Tensor:
    """Per-ray max; -inf for empty rays (jax.ops.segment_max)."""
    out = torch.full((n_rays + 1,) + tuple(x.shape[1:]), float("-inf"),
                     dtype=x.dtype, device=x.device)
    idx = ray_id.long()
    if x.dim() > 1:
        idx = idx.view(-1, *([1] * (x.dim() - 1))).expand_as(x)
    return out.scatter_reduce(0, idx, x, "amax", include_self=True)[:n_rays]


def first_flags_from_ray_id(ray_id: torch.Tensor, n_rays: int) -> torch.Tensor:
    """is_first[k] = sample k starts a new segment (ray_id changes at k)."""
    prev = torch.cat([ray_id.new_full((1,), -1), ray_id[:-1]])
    return (ray_id != prev) & (ray_id < n_rays)


def local_index(ray_id: torch.Tensor, n_rays: int) -> torch.Tensor:
    """Index of each sample within its ray (0-based), int32: JAX's
    exclusive segmented scan of ones, ``ray_offsets``' third output (the
    offsets launch on the card). Padding rows continue the last ray's
    count, as in the JAX package."""
    return ray_offsets(ray_id, n_rays)[2]
