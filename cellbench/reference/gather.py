"""Frozen plain copy of the port's ``ops.gather``: every kernel dispatch replaced by the plain version it routes CPU tensors to, so this module runs plain torch on any device. It imports nothing of the port; cellbench's reference runs it.

Row gather ``out[i, :] = table[idx[i], :]``: kernel K4's wrapper and its
plain version.

K4 (csrc/row_gather.cu) is the port of the Pallas kernel
``benchmarks/micro_gather.py::pallas_gather_case``. On the main path it is
the forward of ``hash_block_grad_pass`` (and of ``hash_block_gather_cached``,
fields/hash_block.py), which gathers the grad pass's encodings from the
prefilter's cache."""
from __future__ import annotations
import torch

def row_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4 (raises on an index out of range)."""
    return torch.index_select(table, 0, idx.long())

def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` [n] (int32 or int64) of the f32 ``table`` [t, W]:
    [n, W] f32. CPU tensors take the plain version; CUDA tensors launch K4
    (no launch for an empty result), which trusts the indices to be in
    range."""
    return row_gather_plain(table, idx)
