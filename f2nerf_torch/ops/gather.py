"""Row gather ``out[i, :] = table[idx[i], :]``: kernel K4's wrapper and its
plain version.

K4 (csrc/row_gather.cu) is the port of the Pallas kernel
``benchmarks/micro_gather.py::pallas_gather_case``. On the main path it is
the forward of ``hash_block_grad_pass`` (and of ``hash_block_gather_cached``,
fields/hash_block.py), which gathers the grad pass's encodings from the
prefilter's cache.
"""

from __future__ import annotations

import torch

from .. import kernels


def row_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4 (raises on an index out of range)."""
    return torch.index_select(table, 0, idx.long())


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` [n] (int32 or int64) of the f32 ``table`` [t, W]:
    [n, W] f32. CPU tensors take the plain version; CUDA tensors launch K4
    (no launch for an empty result), which trusts the indices to be in
    range."""
    if table.device.type == "cpu":
        return row_gather_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"row_gather: unsupported device {table.device}")
    if table.dtype != torch.float32 or table.dim() != 2:
        raise ValueError(f"row_gather: table must be [t, W] float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if idx.dtype not in (torch.int32, torch.int64) or idx.dim() != 1:
        raise ValueError(f"row_gather: idx must be [n] int32/int64, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    table, idx = table.contiguous(), idx.contiguous()
    kernels.require_cuda("row_gather", table, idx)
    n, w = idx.shape[0], table.shape[1]
    out = torch.empty((n, w), dtype=torch.float32, device=table.device)
    if n == 0 or w == 0:
        return out
    code = kernels.library().f2_row_gather(
        table.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64),
        out.data_ptr(), n, w, kernels.stream_ptr(table.device))
    kernels.check(code, "row_gather")
    row_gather.launches += 1
    return out


row_gather.launches = 0
