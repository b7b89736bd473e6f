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
  * gradients: rtol 1e-5, atol 1e-6 — scatter-adds summed in another order.
Points placed exactly on cell and block boundaries (bias 0, coordinates
that scale to integers) must agree with the op-by-op JAX result exactly as
above: both round per operation, so both pick the same cell.
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
    assert float((d_k - d_p).abs().max()) <= 1e-5 * float(d_p.abs().max())
    assert (thb.hash_block_fwd.launches, thb.hash_block_bwd.launches) == (n0 + 1, n1 + 1)


CARD_CASES = ["ray_ordered", "one_cell", "cz_even", "cz_odd", "n0", "n1", "n33",
              "n1000", "boundary"]


def card_inputs(case: str):
    """(pts [n, 3] f32, vol [n] int32, g [n, 32] f32, zero_bias) for the
    card tests of K2/K3, from a seed:
      ray_ordered: 16 rays x 300 samples stepping 1e-3 along each ray, one
        volume a ray (neighbours share cells at the coarse levels);
      one_cell: 4,096 samples within 1e-7 of one point, one volume (every
        lane of every warp merges, at every level);
      cz_even / cz_odd: zero bias, level 0's z cell c in {0, 2} / {1} for
        every sample (the float4 / float2 atomics);
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
    """K2 bit for bit and K3 within 1e-5 of the largest entry against the
    plain versions, on inputs that stress the tiles, the same-cell merge
    and both atomic widths; K3 also over two segments in one launch."""
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
    tol = 1e-5 * float(d_p.abs().max()) if len(pts) else 0.0
    d_k = thb.hash_block_bwd(g, prim, bias, pts, vol, L2T, shape)
    assert float((d_k - d_p).abs().max()) <= tol
    h = len(pts) // 3
    d_2 = thb.hash_block_bwd((g[:h], g[h:]), prim, bias, (pts[:h], pts[h:]),
                             (vol[:h], vol[h:]), L2T, shape)
    assert float((d_2 - d_p).abs().max()) <= tol
    launched = int(len(pts) > 0)        # no samples: nothing is launched
    assert (thb.hash_block_fwd.launches,
            thb.hash_block_bwd.launches) == (n0 + launched, n1 + 2 * launched)


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
