"""K4's plain version (``row_gather_plain``) against the Pallas kernel it
ports, ``benchmarks/micro_gather.py::pallas_gather_case`` (run in
interpret mode on the CPU, as that file runs it off a TPU), and the cached
gather of the grad pass, which now goes through ``row_gather``.

Tolerances: a gather is exact, so rows are compared bit for bit. The
Pallas case returns only a checksum, the f32 sum of its 4096 x 128 output
(~5e5 values, magnitude ~2e3 to 3e3, where one f32 ulp is 2.4e-4). The
port's rows are summed in float64; JAX's f32 reduction lies up to 6.9e-4
(~3 ulps) from that sum at the three salts, so checksums are held to atol
2e-3.
"""

import importlib.util
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f2nerf_torch.fields import hash_block as thb
from f2nerf_torch.fields.hash_encoding import N_CHANNELS, N_LEVELS
from f2nerf_torch.ops import gather as tg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, T = 4096, 256
CHECKSUM_ATOL = 2e-3


@pytest.fixture(scope="module")
def micro_gather():
    spec = importlib.util.spec_from_file_location(
        "micro_gather", os.path.join(REPO, "benchmarks", "micro_gather.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pallas_case(micro_gather):
    np.random.seed(0)
    fn, (table, idx), n = micro_gather.pallas_gather_case(N, T)
    assert n == N
    return jax.jit(partial(fn, iters=1)), np.array(table), np.array(idx)


def salted(idx, salt):
    """The index the case gathers at loop step 0 for ``salt``."""
    return (idx.astype(np.int64) + salt * 7919) % T


@pytest.mark.parametrize("salt", [1, 2, 5])
def test_checksum_matches_pallas_kernel(pallas_case, salt):
    fn, table, idx = pallas_case
    want = float(fn(jnp.int32(salt), jnp.asarray(table), jnp.asarray(idx)))
    ix = torch.from_numpy(salted(idx, salt).astype(np.int32))
    rows = tg.row_gather_plain(torch.from_numpy(table), ix)
    assert tuple(rows.shape) == (N, 128)
    got = float(rows.double().sum())
    assert abs(got) > 10.0
    assert got == pytest.approx(want, abs=CHECKSUM_ATOL)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_rows_match_jnp_take_exactly(pallas_case, dtype):
    _, table, idx = pallas_case
    ix = salted(idx, 3)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ix.astype(np.int32)), axis=0))
    got = tg.row_gather(torch.from_numpy(table), torch.from_numpy(ix).to(dtype))
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_raises_out_of_range():
    table = torch.zeros((4, 8))
    with pytest.raises(IndexError):
        tg.row_gather_plain(table, torch.tensor([0, 4], dtype=torch.int32))


def test_gather_cached_forward_and_backward():
    """Forward: the cache's rows (through row_gather); backward: K3's plain
    table gradient of the gathered points, as before."""
    g = torch.Generator().manual_seed(0)
    l2t, nv = 12, 3
    feat, prim, bias = thb.init_block_state(g, l2t, nv)
    feat = torch.randn(feat.shape, generator=g)
    rng = np.random.RandomState(1)
    pts_a = torch.from_numpy(rng.rand(96, 3).astype(np.float32))
    vol_a = torch.from_numpy(rng.randint(0, nv, 96).astype(np.int32))
    enc_a = thb.hash_block_encode(feat, prim, bias, pts_a, vol_a, l2t).detach()
    idx = torch.from_numpy(rng.choice(96, 40, replace=True).astype(np.int64))
    w = torch.from_numpy(rng.randn(40, N_LEVELS * N_CHANNELS).astype(np.float32))
    leaf = feat.clone().requires_grad_(True)
    out = thb.hash_block_gather_cached(leaf, prim, bias, pts_a[idx], vol_a[idx],
                                       l2t, enc_a, idx)
    assert torch.equal(out, enc_a[idx])
    (out * w).sum().backward()
    want = thb.hash_block_bwd_plain(w, prim, bias, pts_a[idx], vol_a[idx], l2t,
                                    tuple(feat.shape))
    assert torch.equal(leaf.grad, want)


def test_wrapper_refuses_other_devices_and_types():
    with pytest.raises(ValueError):
        tg.row_gather(torch.zeros((4, 8), device="meta"),
                      torch.zeros(2, dtype=torch.int32, device="meta"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("w,misalign,dtype", [
    (128, 0, torch.int32), (128, 0, torch.int64), (32, 0, torch.int64),
    (32, 1, torch.int32), (3, 0, torch.int64), (200, 0, torch.int32)])
def test_kernel_matches_plain_on_card(cuda, w, misalign, dtype):
    g = torch.Generator(device=cuda).manual_seed(w)
    t, n = 1000, 12345
    buf = torch.randn(t * w + misalign, generator=g, device=cuda)
    table = buf[misalign:].view(t, w)       # contiguous, 4-byte offset if misaligned
    idx = torch.randint(0, t, (n,), generator=g, device=cuda).to(dtype)
    n0 = tg.row_gather.launches
    got = tg.row_gather(table, idx)
    torch.cuda.synchronize()
    assert tg.row_gather.launches == n0 + 1
    assert torch.equal(got, tg.row_gather_plain(table, idx))
    with pytest.raises(ValueError):
        tg.row_gather(table.double(), idx)


def _check_on_card(table, idx):
    n0 = tg.row_gather.launches
    got = tg.row_gather(table, idx)
    torch.cuda.synchronize()
    assert tg.row_gather.launches == n0 + (1 if idx.numel() and table.shape[1] else 0)
    assert got.shape == (idx.shape[0], table.shape[1])
    assert torch.equal(got, tg.row_gather_plain(table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 33, 1023, 4099])
@pytest.mark.parametrize("w", [32, 128])
def test_kernel_row_counts_off_the_group_size(cuda, n, w):
    """n = 0, 1 and counts that are not a multiple of the 4 rows a lane
    group takes at once."""
    g = torch.Generator(device=cuda).manual_seed(n)
    table = torch.randn((777, w), generator=g, device=cuda)
    _check_on_card(table, torch.randint(0, 777, (n,), generator=g, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_kernel_all_indices_equal(cuda, dtype):
    """Every row the same index, as the grad pass's padding rows are."""
    g = torch.Generator(device=cuda).manual_seed(2)
    table = torch.randn((5000, 32), generator=g, device=cuda)
    _check_on_card(table, torch.full((70001,), 4999, dtype=dtype, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_kernel_misaligned_indices(cuda, dtype):
    """An index view 4 or 8 bytes off a 16-byte boundary: one load per
    index instead of the vector load."""
    g = torch.Generator(device=cuda).manual_seed(3)
    table = torch.randn((300, 32), generator=g, device=cuda)
    idx = torch.randint(0, 300, (10001,), generator=g, device=cuda).to(dtype)[1:]
    assert idx.data_ptr() % 16 != 0
    _check_on_card(table, idx)


@pytest.mark.cuda
def test_kernel_at_captured_slice_inputs(cuda, tmp_path):
    """The inputs one full-width wanjinyou training step gives K4 (the
    prefilter's [cap1, 32] encodings and the grad pass's int64 indices,
    padding rows at index cap1 - 1), captured by spying on the step."""
    from f2nerf_torch.train.trainer import Trainer
    from f2nerf_torch.utils.config import compose
    from f2nerf_torch.utils.synthetic import write_ball_dataset
    cfg = compose(os.path.join(REPO, "confs"), "wanjinyou", ["+train.fused_adam=true"])
    tr = Trainer(cfg, str(tmp_path / "exp"), write_ball_dataset(str(tmp_path / "ball")),
                 seed=2022, device="cuda")
    calls, real = [], thb.row_gather

    def spy(table, idx):
        calls.append((table, idx))
        return real(table, idx)

    thb.row_gather = spy
    try:
        tr.train_one()
    finally:
        thb.row_gather = real
    assert len(calls) == 1
    table, idx = calls[0]
    assert table.shape[1] == N_LEVELS * N_CHANNELS and idx.dtype == torch.int64
    assert int((idx == table.shape[0] - 1).sum()) > 1
    _check_on_card(table, idx)
