"""The port's segment ops (f2nerf_torch/ops/segment.py) through their
autograd Functions, against the JAX package's (f2nerf_tpu/ops/segment.py,
run on the CPU), forward and backward; and, on the card, kernels K10
(``segment_reduce``) and K11 (``segment_scan``) and the offsets launch
(``ray_offsets``) against their plain versions.

Inputs come from numpy seeds: ray-sorted ids with empty rays and trailing
padding (id == n_rays), a buffer that is all padding, a single 512-sample
ray, and a buffer with no padding.

Tolerances:
  * per-ray sums, and the gathers' backward (a per-ray sum): rtol 1e-5,
    atol 1e-6 — f32 sums in another order than XLA's segment_sum;
  * scans against JAX: rtol 1e-5, atol 1e-6 of the largest |value| compared
    (JAX's associative scan adds in f32, the port in f64: JAX's rounding
    grows with the running sums, ~400 over the 512-sample ray); the
    reverse scan against float64 numpy suffix sums: rtol 1e-6, atol 1e-6;
  * gathers' forward, local_index and the offsets launch's four outputs
    (integers and flags), computed or with the offsets given: exact; the
    sums with the offsets given equal the same calls without them, bit
    for bit;
  * on the card, K10 against index_add: |diff| <= 1e-5 of the ray's sum of
    |x| (both f32, other orders), at C = 1, 2, 6, 8, 16 and 17 (the vector
    path where C is 8 or 16, the scalar one otherwise); K11 against the
    plain f64 cumsum: rtol 1e-6, atol 1e-6 (chip_smoke.py's TOL_SCAN: both
    sum in f64 and round once to f32, so they differ by an f32 ulp at
    most); the same launch twice: the same bits, also 20 times over while
    another stream keeps the card busy.

K11 runs a block a tile of 2,048 rows in one launch; its state (two
counters and a published aggregate a tile) is kept zeroed between calls,
one buffer a device and stream (``scan_state``). On the card its cases
include n = 1, exactly one tile, one tile and a row, no flag at all and
100k+ padding rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f2nerf_tpu.ops import activations as jact
from f2nerf_tpu.ops import segment as jseg
from f2nerf_torch.ops import activations as tact
from f2nerf_torch.ops import segment as tseg
from f2nerf_torch.render import renderer as trend

RTOL, ATOL = 1e-5, 1e-6
CASES = ("ragged", "all_padding", "single_512", "no_padding")


def T(x):
    return torch.from_numpy(np.array(x, copy=True))


def make_case(name: str, seed: int = 0, c: int = 0):
    """(ray_id int32 [cap], x [cap] or [cap, c] f32, n_rays)."""
    rng = np.random.RandomState(seed)
    if name == "ragged":
        n_rays = 40
        counts = rng.randint(0, 30, n_rays)
        counts[rng.randint(0, n_rays, 4)] = 0
        rid = np.concatenate([np.repeat(np.arange(n_rays), counts), np.full(25, n_rays)])
    elif name == "all_padding":
        n_rays = 5
        rid = np.full(37, n_rays)
    elif name == "single_512":
        n_rays = 1
        rid = np.concatenate([np.zeros(512), np.full(9, n_rays)])
    else:
        n_rays = 12
        rid = np.repeat(np.arange(n_rays), rng.randint(1, 20, n_rays))
    shape = rid.shape if c == 0 else rid.shape + (c,)
    x = rng.uniform(-1.0, 2.0, shape).astype(np.float32)
    return rid.astype(np.int32), x, n_rays


def suffix_sums(x, is_first, exclusive):
    """float64 per-segment suffix sums (segments start at is_first and at 0)."""
    out = np.zeros(x.shape[0], np.float64)
    starts = sorted(set([0]) | set(np.nonzero(is_first)[0].tolist())) + [x.shape[0]]
    for s, e in zip(starts[:-1], starts[1:]):
        run = x[s:e].astype(np.float64)
        inc = np.cumsum(run[::-1])[::-1]
        out[s:e] = inc - run if exclusive else inc
    return out


# --------------------------------------------------- sums and gathers vs JAX

@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("c", [0, 6, 16])
def test_segment_sum_forward_backward_match_jax(case, c):
    rid, x, n = make_case(case, seed=c, c=c)
    g = np.random.RandomState(1).randn(*((n,) if c == 0 else (n, c))).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jseg.segment_sum(v, jnp.asarray(rid), n), jnp.asarray(x))
    xt = T(x).requires_grad_(True)
    got = tseg.segment_sum(xt, T(rid), n)
    got.backward(T(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("c", [0, 16])
def test_ray_gather_forward_backward_match_jax(case, c):
    """RayGather against jax.vjp of x[rid] over x with a zero row for the
    padding id."""
    rid, g, n = make_case(case, seed=3, c=c)
    x = np.random.RandomState(4).randn(*((n,) if c == 0 else (n, c))).astype(np.float32)

    def jgather(v):
        return jnp.concatenate([v, jnp.zeros((1,) + v.shape[1:], v.dtype)])[jnp.asarray(rid)]

    want, vjp = jax.vjp(jgather, jnp.asarray(x))
    xt = T(x).requires_grad_(True)
    got = tseg.ray_gather(xt, T(rid), n)
    got.backward(T(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------ scans vs JAX

@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("exclusive", [True, False])
def test_segment_cumsum_forward_backward_match_jax(case, exclusive):
    rid, x, n = make_case(case, seed=5)
    g = np.random.RandomState(6).randn(x.shape[0]).astype(np.float32)
    jf = jseg.first_flags_from_ray_id(jnp.asarray(rid), n)
    want, vjp = jax.vjp(lambda v: jseg.segment_cumsum(v, jf, exclusive=exclusive),
                        jnp.asarray(x))
    xt = T(x).requires_grad_(True)
    tf = tseg.first_flags_from_ray_id(T(rid), n)
    got = tseg.segment_cumsum(xt, tf, exclusive=exclusive)
    got.backward(T(g))
    for a, b in ((got.detach().numpy(), np.asarray(want)),
                 (xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL * max(np.abs(b).max(), 1.0))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("exclusive", [True, False])
def test_reverse_scan_is_the_suffix_sum(case, exclusive):
    """segment_scan(reverse=True): each segment's suffix sums, rows before
    the first flag one segment, padding part of the last ray's."""
    rid, x, n = make_case(case, seed=7)
    tf = tseg.first_flags_from_ray_id(T(rid), n)
    got = tseg.segment_scan(T(x), tf, exclusive=exclusive, reverse=True).numpy()
    np.testing.assert_allclose(got, suffix_sums(x, tf.numpy(), exclusive),
                               rtol=1e-6, atol=1e-6)


def test_scan_without_flags_is_one_segment():
    x = np.random.RandomState(8).uniform(0.0, 1.0, 300).astype(np.float32)
    none = torch.zeros(300, dtype=torch.bool)
    for exclusive in (True, False):
        got = tseg.segment_cumsum(T(x), none, exclusive=exclusive).numpy()
        want = np.asarray(jseg.segment_cumsum(jnp.asarray(x), jnp.zeros(300, bool),
                                              exclusive=exclusive))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", CASES)
def test_local_index_matches_jax_and_plain(case):
    rid, _, n = make_case(case, seed=9)
    got = tseg.local_index(T(rid), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jseg.local_index(jnp.asarray(rid), n)))
    np.testing.assert_array_equal(got.numpy(), tseg.local_index_plain(T(rid), n).numpy())


@pytest.mark.parametrize("case", CASES)
def test_ray_offsets_plain_matches_jax(case):
    """``ray_offsets``' plain version: counts equal JAX's segment_sum of
    ones, local_index JAX's local_index, and each ray's rows are
    [offsets[r], offsets[r + 1]) (offsets[n_rays] the first padding row)."""
    rid, _, n = make_case(case, seed=15)
    offsets, counts, li, first = tseg.ray_offsets(T(rid), n)
    assert (offsets.dtype, counts.dtype, li.dtype, first.dtype) == \
        (torch.int32, torch.float32, torch.int32, torch.bool)
    ones = jnp.ones(rid.shape, jnp.float32)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.asarray(jseg.segment_sum(ones, jnp.asarray(rid), n)))
    np.testing.assert_array_equal(li.numpy(), np.asarray(jseg.local_index(jnp.asarray(rid), n)))
    np.testing.assert_array_equal(offsets.numpy(), np.searchsorted(rid, np.arange(n + 1)))
    np.testing.assert_array_equal(
        first.numpy(), np.asarray(jseg.first_flags_from_ray_id(jnp.asarray(rid), n)))


def test_ray_offsets_plain_of_an_empty_buffer():
    offsets, counts, li, first = tseg.ray_offsets(torch.zeros(0, dtype=torch.int32), 3)
    assert offsets.tolist() == [0, 0, 0, 0] and counts.tolist() == [0.0] * 3
    assert li.shape == (0,) and first.shape == (0,)


@pytest.mark.parametrize("case", CASES)
def test_ray_offsets_given_equal_computed(case):
    """The given-offsets form (the buffer's offsets passed in, as the
    single-pass renderer passes K12's) returns what the computed form
    returns."""
    rid, _, n = make_case(case, seed=19)
    want = tseg.ray_offsets(T(rid), n)
    got = tseg.ray_offsets(T(rid), n, want[0].clone())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_ray_offsets_refuses_bad_offsets_and_dtypes():
    """Given offsets of the wrong length, type or device, and ray ids that
    are not int32, raise; nothing is launched."""
    rid, _, n = make_case("ragged", seed=20)
    good = tseg.ray_offsets(T(rid), n)[0]
    before = tseg.ray_offsets.launches
    for bad in (good[:-1], good.long(), good.float(), good.tolist(),
                torch.zeros(n + 1, dtype=torch.int32, device="meta")):
        with pytest.raises(ValueError, match="offsets must be int32"):
            tseg.ray_offsets(T(rid), n, bad)
    for bad_rid, bad_n in ((T(rid).long(), n), (T(rid).float(), n), (T(rid)[None], n),
                           (T(rid), -1)):
        with pytest.raises(ValueError, match="expected int32 ray_id"):
            tseg.ray_offsets(bad_rid, bad_n)
    assert tseg.ray_offsets.launches == before


@pytest.mark.parametrize("case", CASES)
def test_offsets_given_equal_offsets_computed(case):
    """segment_sum, ray_gather and weight_var with the offsets given: the
    same values and gradients as the same calls without them."""
    rid, x, n = make_case(case, seed=16, c=6)
    offsets, _, li, _ = tseg.ray_offsets(T(rid), n)
    per_ray = np.random.RandomState(17).randn(n, 3).astype(np.float32)
    w = np.abs(x[:, 0])
    out = []
    for off in (None, offsets):
        xt, pt, wt = (T(v).requires_grad_(True) for v in (x, per_ray, w))
        s = tseg.segment_sum(xt, T(rid), n, off)
        gat = tseg.ray_gather(pt, T(rid), n, off)
        var = tact.weight_var(wt, T(rid), li, n, off)
        ((s * s).sum() + (gat * gat).sum() + var.sum()).backward()
        out.append([v.detach() for v in (s, gat, var, xt.grad, pt.grad, wt.grad)])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_wrappers_refuse_bad_offsets():
    """Offsets of the wrong length, type or kind raise, on every route."""
    rid, x, n = make_case("ragged", seed=18, c=2)
    good = tseg.ray_offsets(T(rid), n)[0]
    for bad in (good[:-1], good.long(), good.float(), good.tolist(),
                torch.zeros(n + 1, dtype=torch.int32, device="meta")):
        with pytest.raises(ValueError, match="offsets must be int32"):
            tseg.segment_reduce(T(x), T(rid), n, bad)
        with pytest.raises(ValueError, match="offsets must be int32"):
            tseg.segment_sum(T(x), T(rid), n, bad)
        with pytest.raises(ValueError, match="offsets must be int32"):
            tseg.ray_gather(T(x[:n]), T(rid), n, bad)


# --------------------------------------------------------- callers vs JAX

@pytest.mark.parametrize("case", CASES)
def test_weight_var_forward_backward_match_jax(case):
    rid, w, n = make_case(case, seed=10)
    w = np.abs(w)
    li = np.asarray(jseg.local_index(jnp.asarray(rid), n))
    g = np.random.RandomState(11).randn(n).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jact.weight_var(v, jnp.asarray(rid), jnp.asarray(li), n),
                        jnp.asarray(w))
    wt = T(w).requires_grad_(True)
    got = tact.weight_var(wt, T(rid), T(li), n)
    got.backward(T(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("case", ["ragged", "single_512", "no_padding"])
def test_appearance_gather_matches_jax(case):
    """The renderer's appearance rows (one-hot product, then RayGather)
    against the JAX renderer's ``app_emb[emb_idx[rid_bc]]``: equal on every
    sample row, and the same gradient of app_emb for a cotangent that is
    zero on padding rows (the composite's weights are zero there; the port
    gathers zeros there, the JAX package the last ray's row)."""
    rid, _, n = make_case(case, seed=12)
    rng = np.random.RandomState(13)
    app = rng.randn(7, 16).astype(np.float32)
    emb_idx = rng.randint(0, 7, n).astype(np.int32)
    valid = rid < n
    g = (rng.randn(rid.shape[0], 16) * valid[:, None]).astype(np.float32)
    rid_c = np.minimum(rid, n - 1)
    want, vjp = jax.vjp(lambda a: a[jnp.asarray(emb_idx)[jnp.asarray(rid_c)]], jnp.asarray(app))
    at = T(app).requires_grad_(True)
    got = tseg.ray_gather(trend._image_rows(at, T(emb_idx)), T(rid), n)
    got.backward(T(g))
    np.testing.assert_array_equal(got.detach().numpy()[valid], np.asarray(want)[valid])
    assert not got.detach().numpy()[~valid].any()
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=RTOL, atol=ATOL)


# ------------------------------------------------------ the wrappers' routes

def test_wrappers_take_the_plain_versions_on_the_cpu():
    rid, x, n = make_case("ragged", seed=14, c=6)
    before = (tseg.segment_reduce.launches, tseg.segment_scan.launches)
    assert torch.equal(tseg.segment_reduce(T(x), T(rid), n),
                       tseg.segment_sum_plain(T(x), T(rid), n))
    tf = tseg.first_flags_from_ray_id(T(rid), n)
    for reverse in (False, True):
        assert torch.equal(tseg.segment_scan(T(x[:, 0]), tf, True, reverse),
                           tseg.segment_cumsum_plain(T(x[:, 0]), tf, True, reverse))
    assert (tseg.segment_reduce.launches, tseg.segment_scan.launches) == before


def test_wrappers_refuse_other_devices():
    """No quiet route to the plain versions off the CPU: a device that is
    neither the CPU nor CUDA raises."""
    x = torch.zeros(8, device="meta")
    rid = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tseg.segment_reduce(x, rid, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        tseg.segment_scan(x, torch.zeros(8, dtype=torch.bool, device="meta"))


def test_ray_offsets_refuses_other_devices():
    before = tseg.ray_offsets.launches
    with pytest.raises(ValueError, match="unsupported device"):
        tseg.ray_offsets(torch.zeros(8, dtype=torch.int32, device="meta"), 1)
    assert tseg.ray_offsets.launches == before


def test_scan_state_sizes_and_reuse():
    """K11's state: a 16-byte slot for the counters, then 16 bytes a tile
    of SCAN_TILE_ROWS rows; allocated zeroed at a power of two of bytes,
    reused for calls that fit, grown for one that does not, one buffer a
    (device, stream)."""
    tile = tseg.SCAN_TILE_ROWS
    assert tile == 2048
    assert [tseg.scan_state_bytes(n) for n in (1, tile, tile + 1, 262144, 393216)] == \
        [32, 32, 48, 16 * 129, 16 * 193]
    before = dict(tseg._scan_states)
    try:
        a = tseg.scan_state("cpu", 11, tile + 1)
        assert a.dtype == torch.uint8 and a.numel() == 64 and not a.any()
        assert tseg.scan_state("cpu", 11, 5) is a
        b = tseg.scan_state("cpu", 11, 262144)
        assert b is not a and b.numel() == 4096 >= tseg.scan_state_bytes(262144)
        assert tseg.scan_state("cpu", 11, tile) is b
        assert tseg.scan_state("cpu", 12, tile) is not b
    finally:
        tseg._scan_states.clear()
        tseg._scan_states.update(before)


def test_failed_state_launch_drops_its_state():
    """A launch that takes a zeroed state buffer and fails drops it, so the
    next call starts from a new zeroed buffer; a launch that succeeds keeps
    it."""
    states = {}
    a = tseg.zeroed_state(states, "cpu", 7, 100)
    tseg.check_state_launch(0, "k", states, "cpu", 7)
    assert tseg.zeroed_state(states, "cpu", 7, 100) is a
    a.fill_(1)
    with pytest.raises(RuntimeError, match="k failed"):
        tseg.check_state_launch(700, "k", states, "cpu", 7)
    assert not states
    b = tseg.zeroed_state(states, "cpu", 7, 100)
    assert b is not a and b.numel() == 128 and not b.any()


# ----------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def step_case(seed: int, n_rays: int = 2048, per: int = 192, cap: int = 393216):
    """The slice's shape: 2,048 rays of 0-2*per samples (mean per), the rest
    of cap padding."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(0, 2 * per, n_rays)
    rid = np.repeat(np.arange(n_rays), counts)[:cap]
    return np.concatenate([rid, np.full(cap - rid.shape[0], n_rays)]).astype(np.int32), n_rays


def _reduce_on_card(cuda, rid, x, n):
    """K10 within 1e-5 of each ray's sum of |x| of index_add, the same bits
    on a second launch and with the offsets given (one offsets launch, one
    K10 launch a call)."""
    xd, rd = T(x).to(cuda), T(rid).to(cuda)
    offsets = tseg.ray_offsets(rd, n)[0]
    before = (tseg.segment_reduce.launches, tseg.ray_offsets.launches)
    got = tseg.segment_reduce(xd, rd, n)
    again = tseg.segment_reduce(xd, rd, n, offsets)
    assert (tseg.segment_reduce.launches - before[0],
            tseg.ray_offsets.launches - before[1]) == (2, 1)
    want = tseg.segment_sum_plain(xd, rd, n)
    scale = tseg.segment_sum_plain(xd.abs(), rd, n)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-30).all())


def _offsets_on_card(cuda, rid, n):
    """The offsets launch equal to its plain version (all four outputs),
    computed and with the offsets given, each launch repeated bit for
    bit."""
    rd = T(rid).to(cuda)
    want = tseg.ray_offsets_plain(rd, n)
    given = want[0].clone()
    runs = [tseg.ray_offsets(rd, n), tseg.ray_offsets(rd, n),
            tseg.ray_offsets(rd, n, given), tseg.ray_offsets(rd, n, given)]
    torch.cuda.synchronize()
    for got in runs:
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


def _scan_on_card(cuda, rid, x, n):
    xd = T(x).to(cuda)
    tf = tseg.first_flags_from_ray_id(T(rid).to(cuda), n)
    for exclusive in (True, False):
        for reverse in (False, True):
            got = tseg.segment_scan(xd, tf, exclusive, reverse)
            again = tseg.segment_scan(xd, tf, exclusive, reverse)
            want = tseg.segment_cumsum_plain(xd, tf, exclusive, reverse)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32), again.view(torch.int32))
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [0, 1, 2, 6, 8, 16, 17])
def test_k10_matches_plain_at_the_step_shape(cuda, c):
    rid, n = step_case(c)
    x = np.random.RandomState(c).uniform(-1, 2, rid.shape + ((c,) if c else ())).astype(np.float32)
    _reduce_on_card(cuda, rid, x, n)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["unaligned", "slice_of_32", "slice_of_41"])
def test_k10_rows_of_a_wider_buffer(cuda, layout):
    """x [n, 16] read in place: starting one float into its buffer (not
    16-byte aligned: the scalar path), the first 16 columns of an [n, 32]
    buffer (the vector path with a row stride of 32, as the appearance
    gather's gradient is) and of an [n, 41] buffer (the scalar path)."""
    rid, n = step_case(29, n_rays=256, per=50, cap=30000)
    rows = rid.shape[0]
    width = {"unaligned": 16, "slice_of_32": 32, "slice_of_41": 41}[layout]
    flat = np.random.RandomState(29).uniform(-1, 2, rows * width + 1).astype(np.float32)
    buf = T(flat).to(cuda)
    if layout == "unaligned":
        xd = buf[1:].view(-1, 16)
        assert xd.data_ptr() % 16 != 0
    else:
        xd = buf[:-1].view(rows, width)[:, :16]
        assert not xd.is_contiguous() and xd.stride(0) == width
    rd = T(rid).to(cuda)
    got = tseg.segment_reduce(xd, rd, n)
    want = tseg.segment_sum_plain(xd, rd, n)
    scale = tseg.segment_sum_plain(xd.abs(), rd, n)
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-30).all())
    if layout == "slice_of_32":      # the vector path either way: the same order
        assert torch.equal(got.view(torch.int32),
                           tseg.segment_reduce(xd.contiguous(), rd, n).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 16])
def test_k10_holds_offsets_to_the_rows_of_x(cuda, c):
    """Offsets of a longer buffer (the last entries past x's 10 rows, one
    before row 0): K10 sums only x's own rows of each ray, on both paths."""
    x = np.random.RandomState(41).uniform(-1, 2, (10, c)).astype(np.float32)
    offsets = np.array([-3, 3, 6, 12, 20], np.int32)
    rid = np.array([0, 0, 0, 1, 1, 1, 2, 2, 2, 2], np.int32)
    got = tseg.segment_reduce(T(x).to(cuda), T(rid).to(cuda), 4, T(offsets).to(cuda)).cpu()
    want = tseg.segment_sum_plain(T(x), T(rid), 4)
    scale = tseg.segment_sum_plain(T(np.abs(x)), T(rid), 4)
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["step", "no_rows", "empty_buffer", *CASES])
def test_ray_offsets_on_card(cuda, case):
    """The offsets launch at the step's shape, the edge cases, rays with no
    rows (n_rays 0 and a buffer of padding) and an empty buffer."""
    if case == "step":
        rid, n = step_case(30, per=64, cap=262144)
    elif case == "no_rows":
        rid, n = np.zeros(5000, np.int32), 0
    elif case == "empty_buffer":
        rid, n = np.zeros(0, np.int32), 7
    else:
        rid, _, n = make_case(case, seed=31)
    _offsets_on_card(cuda, rid, n)


@pytest.mark.cuda
def test_k11_matches_plain_at_the_step_shape(cuda):
    rid, n = step_case(20)
    x = np.random.RandomState(21).uniform(0.0, 2.0, rid.shape).astype(np.float32)
    _scan_on_card(cuda, rid, x, n)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_k10_k11_edge_cases(cuda, case):
    rid, x, n = make_case(case, seed=22, c=6)
    _reduce_on_card(cuda, rid, x, n)
    _scan_on_card(cuda, rid, x[:, 0].copy(), n)


@pytest.mark.cuda
def test_k11_long_unflagged_tail(cuda):
    """A last segment 100k rows long (the padding of a compacted buffer),
    and a buffer with no flag at all: many windows carry into one
    segment."""
    rid = np.concatenate([np.repeat(np.arange(64), 100), np.full(100_000, 64)]).astype(np.int32)
    x = np.random.RandomState(23).uniform(0.0, 1.0, rid.shape).astype(np.float32)
    _scan_on_card(cuda, rid, x, 64)
    _scan_on_card(cuda, np.full(70_001, 3, np.int32), x[:70_001].copy(), 3)


def tile_edge_case(name: str):
    """(ray_id, x, n_rays) at K11's edges: one row, exactly one tile, one
    tile and a row, no flag at all, and 120k padding rows after the rays."""
    rng = np.random.RandomState(26)
    tile = tseg.SCAN_TILE_ROWS
    if name == "no_flag":
        rid = np.full(3 * tile + 17, 5)
    elif name == "padding":
        rid = np.concatenate([np.repeat(np.arange(100), rng.randint(0, 40, 100)),
                              np.full(120_000, 100)])
    else:
        n = {"n1": 1, "one_tile": tile, "tile_plus_1": tile + 1}[name]
        rid = np.sort(rng.randint(0, 5 if n == 1 else n // 7, n))
    n_rays = int(rid.max()) if name in ("no_flag", "padding") else int(rid.max()) + 1
    x = rng.uniform(0.0, 2.0, rid.shape).astype(np.float32)
    return rid.astype(np.int32), x, n_rays


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["n1", "one_tile", "tile_plus_1", "no_flag", "padding"])
def test_k11_tile_edges(cuda, name):
    rid, x, n = tile_edge_case(name)
    if name == "no_flag":
        assert not tseg.first_flags_from_ray_id(T(rid), n).any()
    _scan_on_card(cuda, rid, x, n)


@pytest.mark.cuda
def test_k11_repeats_while_another_stream_is_busy(cuda):
    """20 launches at the step's shape while a second stream runs a long
    kernel: the same bits every time (no order depends on timing), one
    launch a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rid, n = step_case(27, per=64, cap=262144)
    xd = T(np.random.RandomState(28).uniform(0.0, 1.0, rid.shape).astype(np.float32)).to(cuda)
    tf = tseg.first_flags_from_ray_id(T(rid).to(cuda), n)
    want = tseg.segment_scan(xd, tf)
    side = torch.cuda.Stream()
    outs = []
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)              # ~0.1 s of the side stream
    for _ in range(20):
        outs.append(tseg.segment_scan(xd, tf))
    torch.cuda.synchronize()
    for o in outs:
        assert torch.equal(o.view(torch.int32), want.view(torch.int32))
    torch.testing.assert_close(want, tseg.segment_cumsum_plain(xd, tf), rtol=1e-6, atol=1e-6)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tseg.segment_scan(xd, tf)
        torch.cuda.synchronize()
    on_card = [e.name for e in prof.events() if e.device_type != DeviceType.CPU]
    assert len(on_card) == 1 and "segment_scan" in on_card[0], on_card


@pytest.mark.cuda
def test_functions_on_card_match_cpu(cuda):
    """SegmentSum, SegmentCumsum and RayGather forward and backward: the
    kernels on the card against the plain versions on the CPU."""
    rid, n = step_case(24, n_rays=256, per=100, cap=60000)
    rng = np.random.RandomState(25)
    x6 = rng.uniform(-1, 1, (rid.shape[0], 6)).astype(np.float32)
    x1 = rng.uniform(0, 1, rid.shape[0]).astype(np.float32)
    per_ray = rng.randn(n, 16).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        a, b, p = (T(v).to(dev).requires_grad_(True) for v in (x6, x1, per_ray))
        r = T(rid).to(dev)
        s = tseg.segment_sum(a, r, n)
        cs = tseg.segment_cumsum(b, tseg.first_flags_from_ray_id(r, n))
        gat = tseg.ray_gather(p, r, n)
        ((s * s).sum() + (cs * cs).sum() + (gat * gat.detach()).sum()).backward()
        out[str(dev)] = [v.detach().cpu() for v in (s, cs, gat, a.grad, b.grad, p.grad)]
    for got, want in zip(out[str(cuda)], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
