"""The port's HashBlock encode (K2's plain version), its table gradient
(K3's plain version) and the cached gather, against the JAX package's
``hash_block_encode`` / ``hash_block_gather_cached`` on identical inputs.

Tolerances:
  * against JAX run op by op (``jax.disable_jit``): rtol/atol 1e-6 — the
    same rounded index math; the JAX forward sums a 128-lane masked
    product where the port sums 8 corners, so the last bit may differ;
  * against JAX compiled: the XLA CPU compiler contracts x = p*scale+bias
    into an FMA, which moves x by up to one ulp (~1e-4 at x ~ 1000) and so
    the trilinear weights by ~1e-4; entries whose coordinates lie within
    1e-3 of a lattice plane may land in the neighbouring cell and are
    masked, as tests/test_hash_block.py does (rtol 2e-3, atol 1e-3);
  * gradients: rtol 1e-5, atol 1e-6 — scatter-adds summed in another order
    (K3's order cuts a row's list into windows of K3_WINDOW positions,
    where JAX adds in sample order); with at most K3_WINDOW samples there
    is one window a level and the gradient is JAX's op by op bit for bit.
Points placed exactly on cell and block boundaries (bias 0, coordinates
that scale to integers) must agree with the op-by-op JAX result exactly as
above: both round per operation, so both pick the same cell.

K3's order (csrc/hash_block.cu) is also written out with numpy float32
scalars (``order_reference``) and the plain version held to it bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f2nerf_tpu.fields import hash_block as jhb
from f2nerf_torch.fields import hash_block as thb
from f2nerf_torch.fields.hash_encoding import N_CHANNELS, N_LEVELS, level_scales

L2T = 12
NV = 3


@pytest.fixture(scope="module")
def state():
    feat, prim, bias = jhb.init_block_state(jax.random.PRNGKey(0), L2T, n_volumes=NV)
    feat = jax.random.normal(jax.random.PRNGKey(1), feat.shape)
    return feat, prim, bias


def port(feat, prim, bias):
    return (torch.tensor(np.asarray(feat)),
            torch.tensor(np.asarray(prim).astype(np.int32)),
            torch.tensor(np.asarray(bias)))


def inputs(seed, n):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 3).astype(np.float32), rng.randint(0, NV, n).astype(np.int32),
            rng.randn(n, N_LEVELS * N_CHANNELS).astype(np.float32))


def boundary_points():
    """Coordinates that scale to exact integers at every level whose scale
    is a power of two (levels 0 and 15: 8 and 1024), hitting cell (k/8)
    and block (3k/8) boundaries, plus the domain corners."""
    vals = np.array([0.0, 0.125, 0.375, 0.5, 0.75, 1.0, 3.0 / 1024, 6.0 / 1024],
                    np.float32)
    g = np.stack(np.meshgrid(vals, vals, vals, indexing="ij"), -1).reshape(-1, 3)
    return g[np.random.RandomState(0).permutation(len(g))[:96]]


def jax_eager_encode(feat, prim, bias, pts, vol):
    with jax.disable_jit():
        return np.asarray(jhb.hash_block_encode(feat, prim, bias, jnp.asarray(pts),
                                                jnp.asarray(vol), L2T))


def lattice_safe(pts, vol, bias):
    """[n, 32] mask: False where a coordinate is within 1e-3 of a plane."""
    sc = level_scales()
    x = pts[:, None, :] * sc[None, :, None] + np.asarray(bias)[:, vol].transpose(1, 0, 2)
    safe = (np.abs(x - np.round(x)) > 1e-3).all(-1)
    return np.repeat(safe, N_CHANNELS, axis=1)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_jax_op_by_op(state, seed):
    feat, prim, bias = state
    pts, vol, _ = inputs(seed, 128)
    got = thb.hash_block_encode(*port(feat, prim, bias), torch.from_numpy(pts),
                                torch.from_numpy(vol), L2T).numpy()
    np.testing.assert_allclose(got, jax_eager_encode(feat, prim, bias, pts, vol),
                               rtol=1e-6, atol=1e-6)


def test_forward_matches_jax_compiled_off_lattice(state):
    feat, prim, bias = state
    pts, vol, _ = inputs(2, 2048)
    got = thb.hash_block_encode(*port(feat, prim, bias), torch.from_numpy(pts),
                                torch.from_numpy(vol), L2T).numpy()
    want = np.asarray(jax.jit(jhb.hash_block_encode, static_argnums=5)(
        feat, prim, bias, jnp.asarray(pts), jnp.asarray(vol), L2T))
    safe = lattice_safe(pts, vol, bias)
    assert safe.mean() > 0.5
    np.testing.assert_allclose(got[safe], want[safe], rtol=2e-3, atol=1e-3)


@pytest.mark.parametrize("with_bias", [False, True])
def test_boundary_points_match_jax(state, with_bias):
    feat, prim, bias = state
    # integer biases keep scaled boundary coordinates exact
    b = np.round(np.asarray(bias)) if with_bias else np.zeros_like(np.asarray(bias))
    b = jnp.asarray(b.astype(np.float32))
    pts = boundary_points()
    vol = (np.arange(len(pts)) % NV).astype(np.int32)
    got = thb.hash_block_encode(*port(feat, prim, b), torch.from_numpy(pts),
                                torch.from_numpy(vol), L2T).numpy()
    np.testing.assert_allclose(got, jax_eager_encode(feat, prim, b, pts, vol),
                               rtol=1e-6, atol=1e-6)


def test_table_gradient_matches_jax(state):
    feat, prim, bias = state
    pts, vol, g = inputs(3, 96)
    pts = np.concatenate([pts, boundary_points()[:32]])
    vol = np.concatenate([vol, np.zeros(32, np.int32)])
    g = np.concatenate([g, np.ones((32, g.shape[1]), np.float32)])
    with jax.disable_jit():
        gj = jax.grad(lambda f: jnp.sum(jhb.hash_block_encode(
            f, prim, bias, jnp.asarray(pts), jnp.asarray(vol), L2T) * g))(feat)
    tf, tp, tb = port(feat, prim, bias)
    tf.requires_grad_(True)
    out = thb.hash_block_encode(tf, tp, tb, torch.from_numpy(pts), torch.from_numpy(vol), L2T)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-6)
    # gradient flows to the tables only, and each (sample, level) touches
    # one row with trilinear weights summing to one per channel
    assert np.isclose(tf.grad.numpy().sum(), (g[:, 0::2] + g[:, 1::2]).sum(), rtol=1e-4)


def test_gather_cached_matches_jax(state):
    """Forward: a row gather of the cache; backward: the same table
    gradient as the direct encode of the gathered points (K3)."""
    feat, prim, bias = state
    pts_a, vol_a, _ = inputs(4, 64)
    idx = np.random.RandomState(5).choice(64, 24, replace=False).astype(np.int32)
    pts_b, vol_b = pts_a[idx], vol_a[idx]
    w = np.random.RandomState(6).randn(24, N_LEVELS * N_CHANNELS).astype(np.float32)
    with jax.disable_jit():
        enc_a = jhb.hash_block_encode(feat, prim, bias, jnp.asarray(pts_a),
                                      jnp.asarray(vol_a), L2T)

        def jcached(f):
            return jhb.hash_block_gather_cached(f, prim, bias, jnp.asarray(pts_b),
                                                jnp.asarray(vol_b), L2T, enc_a,
                                                jnp.asarray(idx))
        fwd_j = np.asarray(jcached(feat))
        gj = jax.grad(lambda f: jnp.sum(jcached(f) * w))(feat)
    tf, tp, tb = port(feat, prim, bias)
    enc_t = thb.hash_block_encode(tf, tp, tb, torch.from_numpy(pts_a),
                                  torch.from_numpy(vol_a), L2T).detach()
    tf.requires_grad_(True)
    out = thb.hash_block_gather_cached(tf, tp, tb, torch.from_numpy(pts_b),
                                       torch.from_numpy(vol_b), L2T, enc_t,
                                       torch.from_numpy(idx))
    np.testing.assert_allclose(out.detach().numpy(), fwd_j, rtol=1e-6, atol=1e-6)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-6)


def test_grad_pass_matches_jax(state):
    """The grad pass as one autograd node (B's cached encodings plus the
    edge samples' encode, one table-gradient scatter): the same encodings
    and the same table gradient as the JAX package's
    hash_block_gather_cached + hash_block_encode."""
    feat, prim, bias = state
    pts_a, vol_a, _ = inputs(8, 64)
    idx = np.random.RandomState(9).choice(64, 24, replace=False).astype(np.int32)
    pts_b, vol_b = pts_a[idx], vol_a[idx]
    pts_e, vol_e, _ = inputs(10, 16)
    rng = np.random.RandomState(11)
    w_b = rng.randn(24, N_LEVELS * N_CHANNELS).astype(np.float32)
    w_e = rng.randn(16, N_LEVELS * N_CHANNELS).astype(np.float32)
    with jax.disable_jit():
        enc_a = jhb.hash_block_encode(feat, prim, bias, jnp.asarray(pts_a),
                                      jnp.asarray(vol_a), L2T)

        def jloss(f):
            eb = jhb.hash_block_gather_cached(f, prim, bias, jnp.asarray(pts_b),
                                              jnp.asarray(vol_b), L2T, enc_a,
                                              jnp.asarray(idx))
            ee = jhb.hash_block_encode(f, prim, bias, jnp.asarray(pts_e),
                                       jnp.asarray(vol_e), L2T)
            return jnp.sum(eb * w_b) + jnp.sum(ee * w_e), (eb, ee)
        gj, (eb_j, ee_j) = jax.grad(jloss, has_aux=True)(feat)
    tf, tp, tb = port(feat, prim, bias)
    enc_t = thb.hash_block_encode(tf, tp, tb, torch.from_numpy(pts_a),
                                  torch.from_numpy(vol_a), L2T).detach()
    tf.requires_grad_(True)
    eb, ee = thb.hash_block_grad_pass(tf, tp, tb, torch.from_numpy(pts_b),
                                      torch.from_numpy(vol_b), L2T, enc_t,
                                      torch.from_numpy(idx), torch.from_numpy(pts_e),
                                      torch.from_numpy(vol_e))
    np.testing.assert_allclose(eb.detach().numpy(), np.asarray(eb_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ee.detach().numpy(), np.asarray(ee_j), rtol=1e-6, atol=1e-6)
    ((eb * torch.from_numpy(w_b)).sum() + (ee * torch.from_numpy(w_e)).sum()).backward()
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-6)


def test_scatter_segments_sum_like_one_input(state):
    """K3's plain version over two segments is the scatter of their
    concatenation (the kernel takes the grad pass's B and edge samples as
    two segments of one launch)."""
    tf, tp, tb = port(*state)
    pts, vol, g = (torch.from_numpy(x) for x in inputs(12, 80))
    shape = tuple(tf.shape)
    whole = thb.hash_block_bwd(g, tp, tb, pts, vol, L2T, shape)
    split = thb.hash_block_bwd((g[:50], g[50:]), tp, tb, (pts[:50], pts[50:]),
                               (vol[:50], vol[50:]), L2T, shape)
    assert torch.equal(whole, split)


def test_table_gradient_bit_for_bit_jax_op_by_op(state):
    """At most K3_WINDOW samples: one window a level, so K3's order is JAX's
    scatter order (rows in sample order) and the gradient is the same
    bits."""
    feat, prim, bias = state
    pts, vol, g = inputs(17, thb.K3_WINDOW)
    with jax.disable_jit():
        gj = jax.grad(lambda f: jnp.sum(jhb.hash_block_encode(
            f, prim, bias, jnp.asarray(pts), jnp.asarray(vol), L2T) * g))(feat)
    tf, tp, tb = port(feat, prim, bias)
    tf.requires_grad_(True)
    out = thb.hash_block_encode(tf, tp, tb, torch.from_numpy(pts), torch.from_numpy(vol), L2T)
    (out * torch.from_numpy(g)).sum().backward()
    assert np.array_equal(tf.grad.numpy().view(np.int32), np.asarray(gj).view(np.int32))


def order_inputs(case: str, n: int):
    """(pts, vol, g) for the order checks: ``uniform`` points, ``one_row``
    (every sample within 1e-7 of one point, one volume: one row a level),
    each with a third of the samples' g zero (padding rows) and one
    sample's g -0.0 (also no pair)."""
    rng = np.random.RandomState(len(case) + n)
    if case == "one_row":
        pts = np.float32([0.31, 0.62, 0.27]) + rng.rand(n, 3) * 1e-7
        vol = np.full(n, 1)
    else:
        pts, vol = rng.rand(n, 3), rng.randint(0, NV, n)
    g = rng.randn(n, N_LEVELS * N_CHANNELS).astype(np.float32)
    g[rng.rand(n) < 1 / 3] = 0.0
    g[1] = -0.0
    return pts.astype(np.float32), vol.astype(np.int32), g


def order_reference(tp, tb, pts, vol, g, window: int) -> np.ndarray:
    """K3's order with numpy float32 scalars, row by row: per level, the
    pairs with g != 0 listed by row (numpy's stable argsort: sample order
    within a row), cut into windows of ``window`` positions; a row's
    entries added to +0 within each window in list order, its windows'
    sums added to +0 in window order."""
    nb = thb.n_blocks(L2T)
    vol_t = torch.from_numpy(vol).long()
    d = np.zeros((N_LEVELS * nb, thb.LANES), np.float32)
    for l in range(N_LEVELS):
        row, axes = thb._locate(torch.from_numpy(pts), tp[l, vol_t], tb[l, vol_t],
                                float(level_scales()[l]), nb)
        row = row.numpy()
        corners = [(lane.numpy(), w.numpy()) for lane, w in thb._corners(axes)]
        act = np.nonzero((g[:, 2 * l] != 0) | (g[:, 2 * l + 1] != 0))[0]
        order = act[np.argsort(row[act], kind="stable")]
        for r in np.unique(row[order]):
            where = np.nonzero(row[order] == r)[0]
            acc = np.zeros(thb.LANES, np.float32)
            for win in np.unique(where // window):
                part = np.zeros(thb.LANES, np.float32)
                for pos in where[where // window == win]:
                    i = order[pos]
                    for lane, w in corners:
                        for ch in range(N_CHANNELS):
                            part[lane[i] + ch] = np.float32(part[lane[i] + ch]
                                                            + g[i, 2 * l + ch] * w[i])
                acc = (acc + part).astype(np.float32)
            d[l * nb + r] = acc
    return d.reshape(N_LEVELS, nb, thb.LANES)


def test_k3_list_matches_numpy_stable_argsort(state):
    """The plain version's keys and bucketing: each level's active pairs by
    row, in sample order within a row, as numpy's stable argsort lists
    them."""
    _, tp, tb = port(*state)
    pts, vol, g = order_inputs("uniform", 300)
    nb = thb.n_blocks(L2T)
    for l in range(N_LEVELS):
        rows, idx, _ = thb.k3_list(torch.from_numpy(g), tp, tb, torch.from_numpy(pts),
                                   torch.from_numpy(vol).long(), nb, l)
        want_row, _ = thb._locate(torch.from_numpy(pts), tp[l, torch.from_numpy(vol).long()],
                                  tb[l, torch.from_numpy(vol).long()],
                                  float(level_scales()[l]), nb)
        act = np.nonzero((g[:, 2 * l] != 0) | (g[:, 2 * l + 1] != 0))[0]
        want = act[np.argsort(want_row.numpy()[act], kind="stable")]
        assert np.array_equal(idx.numpy(), want)
        assert np.array_equal(rows.numpy(), want_row.numpy()[want])


@pytest.mark.parametrize("case,n,window,split", [
    ("uniform", 300, thb.K3_WINDOW, 0), ("uniform", 300, 8, 0), ("one_row", 200, 16, 0),
    ("one_row", 200, 16, 77), ("uniform", 240, 5, 150)])
def test_plain_sums_in_k3_order(state, case, n, window, split):
    """The plain version against ``order_reference`` bit for bit: windows
    that hold whole rows and cut them, one row a level holding every
    sample (``one_row``: the skew of the coarse levels), pairs with g = 0
    or -0.0 left out (an entry no pair touches is +0.0), and two segments
    (``split``: the grad pass's B then its edge samples) summed as their
    concatenation in order."""
    _, tp, tb = port(*state)
    pts, vol, g = order_inputs(case, n)
    shape = (N_LEVELS, thb.n_blocks(L2T), thb.LANES)
    segs = (lambda x: (torch.from_numpy(x[:split]), torch.from_numpy(x[split:]))) if split \
        else torch.from_numpy
    got = thb.hash_block_bwd_plain(segs(g), tp, tb, segs(pts), segs(vol), L2T, shape,
                                   window=window).numpy()
    want = order_reference(tp, tb, pts, vol, g, window)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    # no -0.0: an entry is a sum from +0
    assert not np.signbit(got[got == 0]).any()
    if case == "one_row":       # one row a level carries it all
        assert ((np.abs(got).sum(-1) > 0).sum(-1) == 1).all()


def test_init_block_state_shapes_and_ranges():
    g = torch.Generator().manual_seed(0)
    feat, prim, bias = thb.init_block_state(g, L2T, 5)
    assert tuple(feat.shape) == (N_LEVELS, thb.n_blocks(L2T), thb.LANES)
    assert float(feat.max()) <= -0.8e-4 and float(feat.min()) >= -1e-4
    assert prim.dtype == torch.int32 and tuple(prim.shape) == (N_LEVELS, 5, 3)
    p = prim.numpy().astype(np.int64)
    assert ((p >= 1 << 28) & (p < (1 << 30) + 1000)).all() and (p % 2 == 1).all()
    assert 100.0 <= float(bias.min()) and float(bias.max()) < 1100.0


def test_wrappers_refuse_other_devices(state):
    feat, prim, bias = port(*state)
    meta = [t.to("meta") for t in (feat, prim, bias)]
    pts = torch.zeros((4, 3), device="meta")
    vol = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        thb.hash_block_fwd(*meta, pts, vol, L2T)
    with pytest.raises(ValueError):
        thb.hash_block_bwd(torch.zeros((4, 32), device="meta"), *meta[1:], pts, vol,
                           L2T, tuple(feat.shape))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda, state):
    feat, prim, bias = (t.to(cuda) for t in port(*state))
    pts, vol, g = (torch.from_numpy(x).to(cuda) for x in inputs(7, 4096))
    n0, n1 = thb.hash_block_fwd.launches, thb.hash_block_bwd.launches
    torch.testing.assert_close(thb.hash_block_fwd(feat, prim, bias, pts, vol, L2T),
                               thb.hash_block_fwd_plain(feat, prim, bias, pts, vol, L2T),
                               rtol=0, atol=1e-6)
    shape = tuple(feat.shape)
    d_k = thb.hash_block_bwd(g, prim, bias, pts, vol, L2T, shape)
    d_p = thb.hash_block_bwd_plain(g, prim, bias, pts, vol, L2T, shape)
    assert same_bits(d_k, d_p)
    assert (thb.hash_block_fwd.launches, thb.hash_block_bwd.launches) == (n0 + 1, n1 + 1)


CARD_CASES = ["ray_ordered", "one_cell", "cz_even", "cz_odd", "n0", "n1", "n33",
              "n1000", "boundary"]


def card_inputs(case: str):
    """(pts [n, 3] f32, vol [n] int32, g [n, 32] f32, zero_bias) for the
    card tests of K2/K3, from a seed:
      ray_ordered: 16 rays x 300 samples stepping 1e-3 along each ray, one
        volume a ray (neighbours share cells at the coarse levels);
      one_cell: 4,096 samples within 1e-7 of one point, one volume (one
        row a level holds every sample: 64 windows of it);
      cz_even / cz_odd: zero bias, level 0's z cell c in {0, 2} / {1} for
        every sample (a lane's aligned corner pair / pairs split across
        two lanes);
      n0, n1, n33, n1000: sizes that are not a multiple of the 32-sample
        tile, down to 0 and 1;
      boundary: boundary_points() (lattice planes and block boundaries)."""
    rng = np.random.RandomState(CARD_CASES.index(case))
    zero_bias = case in ("cz_even", "cz_odd", "boundary")
    if case == "ray_ordered":
        o = rng.rand(16, 1, 3) * 0.5 + 0.2
        d = rng.randn(16, 1, 3)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        pts = np.clip(o + d * (np.arange(300)[None, :, None] * 1e-3), 0, 1).reshape(-1, 3)
        vol = np.repeat(rng.randint(0, NV, 16), 300)
    elif case == "one_cell":
        pts = np.float32([0.31, 0.62, 0.27]) + rng.rand(4096, 3) * 1e-7
        vol = np.full(4096, 1)
    elif case in ("cz_even", "cz_odd"):
        pts = rng.rand(2048, 3)
        k = rng.randint(0, 2, 2048)             # block 0 or 1 along z
        c = 1 if case == "cz_odd" else 2 * rng.randint(0, 2, 2048)
        pts[:, 2] = (3 * k + c + 0.25 + 0.5 * rng.rand(2048)) / 8.0
        vol = rng.randint(0, NV, 2048)
    elif case == "boundary":
        pts = boundary_points()
        vol = np.arange(len(pts)) % NV
    else:
        n = int(case[1:])
        pts, vol = rng.rand(n, 3), rng.randint(0, NV, n)
    g = rng.randn(len(pts), N_LEVELS * N_CHANNELS)
    return (pts.astype(np.float32), vol.astype(np.int32), g.astype(np.float32),
            zero_bias)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernels_match_plain_on_card_cases(cuda, state, case):
    """K2 and K3 bit for bit against the plain versions, on inputs that
    stress the tiles, one cell holding every sample and both corner-pair
    alignments; K3 also run again (the same bits) and over two segments in
    one call (the plain version of their concatenation)."""
    pts_np, vol_np, g_np, zero_bias = card_inputs(case)
    feat, prim, bias = port(*state)
    if zero_bias:
        bias = torch.zeros_like(bias)
    feat, prim, bias = feat.to(cuda), prim.to(cuda), bias.to(cuda)
    pts, vol, g = (torch.from_numpy(x).to(cuda) for x in (pts_np, vol_np, g_np))
    if case.startswith("cz_"):
        _, axes = thb._locate(pts, prim[0, vol.long()], bias[0, vol.long()],
                              float(level_scales()[0]), thb.n_blocks(L2T))
        assert bool(((axes[2][0] % 2 == 1) == (case == "cz_odd")).all())
    shape = tuple(feat.shape)
    n0, n1 = thb.hash_block_fwd.launches, thb.hash_block_bwd.launches
    assert torch.equal(thb.hash_block_fwd(feat, prim, bias, pts, vol, L2T),
                       thb.hash_block_fwd_plain(feat, prim, bias, pts, vol, L2T))
    d_p = thb.hash_block_bwd_plain(g, prim, bias, pts, vol, L2T, shape)
    d_k = thb.hash_block_bwd(g, prim, bias, pts, vol, L2T, shape)
    assert same_bits(d_k, d_p)
    assert same_bits(thb.hash_block_bwd(g, prim, bias, pts, vol, L2T, shape), d_k)
    h = len(pts) // 3
    d_2 = thb.hash_block_bwd((g[:h], g[h:]), prim, bias, (pts[:h], pts[h:]),
                             (vol[:h], vol[h:]), L2T, shape)
    assert same_bits(d_2, d_p)
    launched = int(len(pts) > 0)        # no samples: nothing is launched
    assert (thb.hash_block_fwd.launches,
            thb.hash_block_bwd.launches) == (n0 + launched, n1 + 3 * launched)


@pytest.mark.cuda
def test_grad_pass_one_scatter_on_card(cuda, state):
    """On the card the grad pass's backward is one K3 launch, and its table
    gradient is the CPU's within 1e-5 of the largest entry."""
    pts_a, vol_a, _ = inputs(13, 2048)
    idx = np.sort(np.random.RandomState(14).choice(2048, 700, replace=False))
    pts_e, vol_e, _ = inputs(15, 512)
    rng = np.random.RandomState(16)
    w_b = torch.from_numpy(rng.randn(700, 32).astype(np.float32))
    w_e = torch.from_numpy(rng.randn(512, 32).astype(np.float32))
    grads = {}
    for dev in ("cpu", cuda):
        f, p, b = (t.to(dev) for t in port(*state))
        args = [torch.from_numpy(x).to(dev) for x in (pts_a, vol_a)]
        enc_a = thb.hash_block_encode(f, p, b, *args, L2T)
        f.requires_grad_(True)
        before = thb.hash_block_bwd.launches
        eb, ee = thb.hash_block_grad_pass(
            f, p, b, args[0][idx], args[1][idx], L2T, enc_a,
            torch.from_numpy(idx).to(dev), torch.from_numpy(pts_e).to(dev),
            torch.from_numpy(vol_e).to(dev))
        ((eb * w_b.to(dev)).sum() + (ee * w_e.to(dev)).sum()).backward()
        if dev != "cpu":
            assert thb.hash_block_bwd.launches == before + 1
        grads[str(dev)] = f.grad.cpu()
    want = grads["cpu"]
    assert float((grads["cuda"] - want).abs().max()) <= 1e-5 * float(want.abs().max())


K3_LARGE = ["one_row_2e18", "n_2e20", "l2t_20"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K3_LARGE)
def test_k3_same_bits_on_card_large(cuda, case):
    """K3 run twice gives the same bits, equal to its plain version, where
    the sort and the windows are large: every sample in one row of each
    level (2^18 samples: 4,096 windows of one row), 2^20 uniform samples
    (many waves of every launch), and log2_table_size 20 (32,768 rows a
    level: the sort's high digit 7 bits), with a third of g zero."""
    l2t = 20 if case == "l2t_20" else 19
    nv = 431
    gen = torch.Generator().manual_seed(K3_LARGE.index(case))
    _, prim, bias = thb.init_block_state(gen, l2t, nv)
    n = {"one_row_2e18": 1 << 18, "n_2e20": 1 << 20, "l2t_20": 393216}[case]
    rng = np.random.RandomState(K3_LARGE.index(case))
    if case == "one_row_2e18":
        pts = np.float32([0.31, 0.62, 0.27]) + rng.rand(n, 3) * 1e-7
        vol = np.full(n, 7)
    else:
        pts, vol = rng.rand(n, 3), rng.randint(0, nv, n)
    g = rng.randn(n, N_LEVELS * N_CHANNELS).astype(np.float32)
    g[rng.rand(n) < 1 / 3] = 0.0
    prim, bias = prim.to(cuda), bias.to(cuda)
    pts, vol, g = (torch.from_numpy(x).to(cuda) for x in (pts.astype(np.float32),
                                                          vol.astype(np.int32), g))
    shape = (N_LEVELS, thb.n_blocks(l2t), thb.LANES)
    d_k = thb.hash_block_bwd(g, prim, bias, pts, vol, l2t, shape)
    assert same_bits(thb.hash_block_bwd(g, prim, bias, pts, vol, l2t, shape), d_k)
    assert same_bits(d_k, thb.hash_block_bwd_plain(g, prim, bias, pts, vol, l2t, shape))
