"""The port's Hash3DAnchored encode (K5's plain version) and its pool
gradient (K6's plain version) against the JAX package's ``hash_encode``
and its custom VJP on identical inputs, and ``init_hash_state``.

Tolerances:
  * against JAX run op by op (``jax.disable_jit``): exactly equal — the
    same per-operation rounding of x = p*scale + bias, the same weights
    (wx*wy)*wz and the same corner order summed from 0;
  * against JAX compiled: the XLA CPU compiler contracts x = p*scale +
    bias into an FMA, which moves x by up to one ulp (~6e-5 at x ~ 1000),
    so the trilinear weights by as much (measured: 15% of the entries
    differ by more than 1e-6, the largest by 5.6e-4 with N(0, 1)
    features); entries whose coordinates lie within 1e-3 of a lattice
    plane may land in the neighbouring cell and are masked (ROADMAP queue
    3); the rest agree to rtol 2e-3, atol 1e-3, as
    tests/test_torch_hash_block.py holds the HashBlock encode;
  * the pool gradient: to 1e-5 of its largest finite entry (JAX sums in
    XLA's scatter order, the port in K6's, csrc/hash3d.cu), NaN and inf
    at the same entries; against K6's order written out in numpy
    (``k6_order_numpy``): bit for bit.
Kernel cases (``cuda`` marker, skipped without a card): K5 and K6 bit for
bit against the plain versions, and K6 against a second run of itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f2nerf_tpu.fields import hash_encoding as jhe
from f2nerf_torch.fields import hash_encoding as the

L2T = 10
NV = 3
NL, NC = the.N_LEVELS, the.N_CHANNELS


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's own intra-op
    pool would oversubscribe the cores, and these are small ops that gain
    nothing from it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def state():
    feat, prim, bias = jhe.init_hash_state(jax.random.PRNGKey(0), L2T, NV)
    feat = jax.random.normal(jax.random.PRNGKey(1), feat.shape)
    return feat, prim, bias


def port(feat, prim, bias):
    return (torch.tensor(np.asarray(feat)),
            torch.tensor(np.asarray(prim).astype(np.int32)),
            torch.tensor(np.asarray(bias)))


def inputs(seed, n):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 3).astype(np.float32), rng.randint(0, NV, n).astype(np.int32),
            rng.randn(n, NL * NC).astype(np.float32))


def lattice_safe(pts, vol, bias):
    """[n, 32] mask: False where a coordinate is within 1e-3 of a plane."""
    sc = the.level_scales()
    x = pts[:, None, :] * sc[None, :, None] + np.asarray(bias)[:, vol].transpose(1, 0, 2)
    safe = (np.abs(x - np.round(x)) > 1e-3).all(-1)
    return np.repeat(safe, NC, axis=1)


def test_local_size_and_constants_match_jax():
    for l2t in (4, 10, 12, 19):
        assert the.local_size(l2t) == jhe.local_size(l2t)
    np.testing.assert_array_equal(the.level_scales(), jhe.level_scales())


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_jax_op_by_op(state, seed):
    feat, prim, bias = state
    pts, vol, _ = inputs(seed, 96)
    got = the.hash_encode(*port(feat, prim, bias), torch.from_numpy(pts),
                          torch.from_numpy(vol), L2T).numpy()
    with jax.disable_jit():
        want = np.asarray(jhe.hash_encode(feat, prim, bias, jnp.asarray(pts),
                                          jnp.asarray(vol), L2T))
    np.testing.assert_array_equal(got, want)


def test_forward_matches_jax_compiled_off_lattice(state):
    feat, prim, bias = state
    pts, vol, _ = inputs(2, 2048)
    got = the.hash_encode(*port(feat, prim, bias), torch.from_numpy(pts),
                          torch.from_numpy(vol), L2T).numpy()
    want = np.asarray(jax.jit(jhe.hash_encode, static_argnums=5)(
        feat, prim, bias, jnp.asarray(pts), jnp.asarray(vol), L2T))
    safe = lattice_safe(pts, vol, bias)
    assert safe.mean() > 0.5
    np.testing.assert_allclose(got[safe], want[safe], rtol=2e-3, atol=1e-3)


def k6_order_numpy(g, prim, bias, pts, vol, l2t, chunk):
    """K6's order written out one record at a time (csrc/hash3d.cu): per
    level, groups of 32 samples in turn; in a group, runs of consecutive
    active samples of one cell, each sample's 8 corner values scanned over
    its run in doubling steps (x_i = x_(i-o) + x_i, o = 1, 2, 4, 8, 16,
    where sample i - o is in i's run), the run's last sample holding its
    value; then corners 0..7, within a corner the runs in order: each run's
    record goes to its entry's bucket in turn; each bucket's list is cut
    into chunks of ``chunk`` records; an entry adds its records in a chunk
    to +0 in order, and the chunks' sums to +0 in chunk order."""
    lsz = the.local_size(l2t)
    hi, lo = the.k6_buckets(l2t)
    assert (hi, lo) == (min(10, lsz.bit_length() - 1), lsz.bit_length() - 1 - hi)
    sc = the.level_scales()
    pu = prim.view(np.uint32)
    d = np.zeros((NL * lsz, NC), np.float32)
    zero = np.zeros(NC, np.float32)
    n = pts.shape[0]
    with np.errstate(over="ignore", invalid="ignore"):
        for l in range(NL):
            buckets = {}
            for s0 in range(0, n, 32):
                lanes = list(range(s0, min(s0 + 32, n)))
                act, key, ent, x = {}, {}, {}, {}
                for s in lanes:
                    gl = g[s, NC * l:NC * l + NC]
                    act[s] = not (gl[0] == 0 and gl[1] == 0)
                    xs = pts[s] * sc[l] + bias[l, vol[s]]
                    f = np.floor(xs)
                    a = xs - f
                    h0 = f.astype(np.int32).astype(np.uint32) * pu[l, vol[s]]
                    h1 = h0 + pu[l, vol[s]]
                    key[s] = (int(vol[s]), *map(int, h0))
                    ent[s], x[s] = [], []
                    for c in range(8):
                        b = ((c >> 2) & 1, (c >> 1) & 1, c & 1)
                        h = np.bitwise_xor.reduce([(h1 if b[ax] else h0)[ax]
                                                   for ax in range(3)])
                        ent[s].append(int(h % np.uint32(lsz)))
                        wa = [a[ax] if b[ax] else np.float32(1) - a[ax] for ax in range(3)]
                        x[s].append(gl * ((wa[0] * wa[1]) * wa[2]))
                same = {s: s > s0 and act[s] and act[s - 1] and key[s] == key[s - 1]
                        for s in lanes}
                start, cur = {}, -1
                for s in lanes:
                    if act[s] and not same[s]:
                        cur = s
                    start[s] = cur
                o = 1
                while o < 32:
                    x = {s: [x[s - o][c] + x[s][c] if act[s] and s - o >= start[s]
                             else x[s][c] for c in range(8)] for s in lanes}
                    o *= 2
                last = [s for s in lanes if act[s] and not (s + 1 in same and same[s + 1])]
                for c in range(8):
                    for s in last:
                        buckets.setdefault(ent[s][c] >> lo, []).append((ent[s][c], x[s][c]))
            for lst in buckets.values():
                acc = {}
                for k0 in range(0, len(lst), chunk):
                    t = {}
                    for e, v in lst[k0:k0 + chunk]:
                        t[e] = t.get(e, zero) + v
                    for e, tv in t.items():
                        acc[e] = acc.get(e, zero) + tv
                for e, av in acc.items():
                    d[l * lsz + e] = av
    return d


def same_or_both_nan(a, b) -> bool:
    """Bit for bit, NaN where the other is NaN (a NaN's payload depends on
    the operand order of the CPU's vector adds)."""
    nan = np.isnan(a)
    return bool((nan == np.isnan(b)).all()
                and np.array_equal(a[~nan].view(np.int32), b[~nan].view(np.int32)))


def special_g(g, rng):
    """g with NaN, +inf and -inf sprinkled in, and zero rows."""
    g = g.copy()
    u = rng.rand(*g.shape)
    g[u < 0.01] = np.nan
    g[(u >= 0.01) & (u < 0.02)] = np.inf
    g[(u >= 0.02) & (u < 0.03)] = -np.inf
    g[::5] = 0.0
    return g


@pytest.mark.parametrize("case", ["random", "chunk8", "nan_inf", "one_cell", "rays", "empty"])
def test_pool_gradient_follows_k6_order(state, case):
    """The plain version against K6's order written out in numpy: chunks
    of 2,048 (one a bucket here) and of 8 (records cut by chunks), NaN and
    inf in g, every sample in one cell a level (runs of a whole group: 8
    entries a level), samples along rays (runs of every length, cut by
    zero rows and by the groups of 32), no sample at all."""
    _, prim, bias = state
    rng = np.random.RandomState(40 + len(case))
    pts, vol, g = inputs(30, 160)
    g[::7] = 0.0
    if case == "nan_inf":
        g = special_g(g, rng)
    if case == "one_cell":
        pts = (np.float32([0.31, 0.62, 0.27]) + rng.rand(*pts.shape) * 1e-7).astype(np.float32)
        vol[:] = 1
    if case == "rays":
        pts = ray_points(rng, 4, 40, 2e-3)
        vol = np.repeat(rng.randint(0, NV, 4), 40).astype(np.int32)
    if case == "empty":
        pts, vol, g = pts[:0], vol[:0], g[:0]
    chunk = 8 if case in ("chunk8", "one_cell", "rays") else the.K6_CHUNK
    _, tp, tb = port(*state)
    got = the.hash_encode_bwd_plain(torch.from_numpy(g), tp, tb, torch.from_numpy(pts),
                                    torch.from_numpy(vol), L2T, NL * the.local_size(L2T),
                                    chunk=chunk).numpy()
    want = k6_order_numpy(g, np.asarray(prim).astype(np.int32), np.asarray(bias), pts,
                          vol, L2T, chunk)
    assert same_or_both_nan(got, want)
    if case not in ("nan_inf", "empty"):
        assert np.abs(want).max() > 0


@pytest.mark.parametrize("case", ["nan_inf", "zero_rows", "one_cell"])
def test_pool_gradient_matches_jax_special(state, case):
    """The plain version against JAX's pool gradient run op by op (the same
    cells): within 1e-5 of the largest finite entry, NaN and +-inf at the
    same entries. Cases: NaN/inf in g, half the rows zero, every sample in
    one cell a level."""
    feat, prim, bias = state
    rng = np.random.RandomState(50 + len(case))
    pts, vol, g = inputs(31, 96)
    if case == "nan_inf":
        g = special_g(g, rng)
    if case == "zero_rows":
        g[rng.rand(g.shape[0]) < 0.5] = 0.0
    if case == "one_cell":
        pts = (np.float32([0.31, 0.62, 0.27]) + rng.rand(*pts.shape) * 1e-7).astype(np.float32)
        vol[:] = 2
    with jax.disable_jit():
        gj = np.asarray(jax.grad(lambda f: jnp.sum(jhe.hash_encode(
            f, prim, bias, jnp.asarray(pts), jnp.asarray(vol), L2T) * g))(feat))
    _, tp, tb = port(feat, prim, bias)
    got = the.hash_encode_bwd(torch.from_numpy(g), tp, tb, torch.from_numpy(pts),
                              torch.from_numpy(vol), L2T, feat.shape[0]).numpy()
    for test in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(test(got), test(gj))
    fin = np.isfinite(gj)
    scale = float(np.abs(gj[fin]).max())
    assert scale > 0
    assert float(np.abs(got[fin] - gj[fin]).max()) <= 1e-5 * scale
    if case == "one_cell":            # 8 entries a level
        assert int((np.abs(got).sum(1) > 0).sum()) <= 8 * NL


def test_pool_gradient_matches_jax(state):
    feat, prim, bias = state
    pts, vol, g = inputs(3, 128)
    g[::7] = 0.0                       # zero rows (the grad pass's padding)
    gj = jax.jit(jax.grad(lambda f: jnp.sum(jhe.hash_encode(
        f, prim, bias, jnp.asarray(pts), jnp.asarray(vol), L2T) * g)))(feat)
    tf, tp, tb = port(feat, prim, bias)
    tf.requires_grad_(True)
    out = the.hash_encode(tf, tp, tb, torch.from_numpy(pts), torch.from_numpy(vol), L2T)
    (out * torch.from_numpy(g)).sum().backward()
    gj = np.asarray(gj)
    assert float(np.abs(tf.grad.numpy() - gj).max()) <= 1e-5 * float(np.abs(gj).max())
    # each (sample, level) spreads its two values over 8 corners with
    # weights summing to one
    assert np.isclose(tf.grad.numpy().sum(), g.sum(), rtol=1e-4)


def test_init_hash_state_shapes_ranges_primes():
    g = torch.Generator().manual_seed(0)
    feat, prim, bias = the.init_hash_state(g, L2T, 5)
    assert tuple(feat.shape) == ((1 << L2T) * NL, NC) and feat.dtype == torch.float32
    assert float(feat.max()) <= -0.8e-4 and float(feat.min()) >= -1e-4
    assert prim.dtype == torch.int32 and tuple(prim.shape) == (NL, 5, 3)
    p = prim.numpy().astype(np.int64)
    assert ((p >= 1 << 28) & (p < (1 << 30) + 1000)).all()
    small = the._small_primes(1 << 15)
    assert not (p.reshape(-1, 1) % small[None, :] == 0).any()      # prime
    assert 100.0 <= float(bias.min()) and float(bias.max()) < 1100.0
    _, _, b0 = the.init_hash_state(torch.Generator().manual_seed(0), L2T, 5,
                                   rand_bias=False)
    assert float(b0.abs().max()) == 0.0
    # the JAX init's shapes and dtypes as the checkpoint carries them
    jf, jp, jb = jhe.init_hash_state(jax.random.PRNGKey(0), L2T, 5)
    assert jf.shape == tuple(feat.shape) and jp.shape == tuple(prim.shape)
    assert jb.shape == tuple(bias.shape) and jp.dtype == jnp.uint32


@pytest.mark.parametrize("case", ["pool_size", "table_size", "grad_shape", "grad_dtype",
                                  "vol_dtype", "pts_shape"])
def test_k6_wrapper_refuses_bad_arguments(state, case):
    """hash_encode_bwd checks its arguments on every device (here the CPU,
    before the plain version): the pool size, log2_table_size past K6's
    2^20 entries a level, g's shape and dtype, vol's dtype, pts' shape."""
    _, prim, bias = port(*state)
    pts, vol, g = (torch.from_numpy(x) for x in inputs(5, 8))
    l2t, pool = L2T, NL * the.local_size(L2T)
    if case == "pool_size":
        pool += NL
    if case == "table_size":
        l2t, pool = 21, NL * the.local_size(21)
    if case == "grad_shape":
        g = g[:, :30]
    if case == "grad_dtype":
        g = g.double()
    if case == "vol_dtype":
        vol = vol.long()
    if case == "pts_shape":
        pts = pts[:, :2]
    with pytest.raises(ValueError):
        the.hash_encode_bwd(g, prim, bias, pts, vol, l2t, pool)


def test_wrappers_refuse_other_devices(state):
    feat, prim, bias = port(*state)
    meta = [t.to("meta") for t in (feat, prim, bias)]
    pts = torch.zeros((4, 3), device="meta")
    vol = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        the.hash_encode_fwd(*meta, pts, vol, L2T)
    with pytest.raises(ValueError):
        the.hash_encode_bwd(torch.zeros((4, 32), device="meta"), *meta[1:], pts,
                            vol, L2T, feat.shape[0])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


CARD_CASES = ["n1", "n33", "n5000", "one_cell", "zero_rows", "ray_ordered",
              "two_volumes", "tile_tail", "zero_tile", "many_blocks", "n0", "nan_inf"]


def ray_points(rng, n_rays, n_per_ray, step):
    """[n_rays * n_per_ray, 3] samples along rays, a ray's consecutive and
    `step` apart, inside [0, 1]^3: a tile's lanes share coarse cells."""
    o = rng.uniform(0.3, 0.7, (n_rays, 1, 3))
    d = rng.randn(n_rays, 1, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.arange(n_per_ray)[None, :, None] * step
    return (o + d * t).reshape(-1, 3).astype(np.float32)


def bits_equal(a, b) -> bool:
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_k6(g, prim, bias, pts, vol, l2t):
    """K6 bit for bit its plain version and a second run of itself, NaN
    included (the card's NaN is one bit pattern), one launch a call."""
    pool = NL * the.local_size(l2t)
    n1 = the.hash_encode_bwd.launches
    d_p = the.hash_encode_bwd_plain(g, prim, bias, pts, vol, l2t, pool)
    d_k = the.hash_encode_bwd(g, prim, bias, pts, vol, l2t, pool)
    d_again = the.hash_encode_bwd(g, prim, bias, pts, vol, l2t, pool)
    torch.cuda.synchronize()
    assert bits_equal(d_k, d_p), int((d_k.view(torch.int32) != d_p.view(torch.int32)).sum())
    assert bits_equal(d_again, d_k)
    assert the.hash_encode_bwd.launches == n1 + 2 * int(pts.shape[0] > 0)


def check_kernels(cuda, feat, prim, bias, pts, vol, g):
    """K5 bit for bit against its plain version, one launch (none for n =
    0), and K6 (``check_k6``)."""
    pts, vol, g = (torch.from_numpy(x).to(cuda) for x in (pts, vol, g))
    n0 = the.hash_encode_fwd.launches
    assert torch.equal(the.hash_encode_fwd(feat, prim, bias, pts, vol, L2T),
                       the.hash_encode_fwd_plain(feat, prim, bias, pts, vol, L2T))
    assert the.hash_encode_fwd.launches == n0 + int(pts.shape[0] > 0)
    check_k6(g, prim, bias, pts, vol, L2T)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernels_match_plain_on_card(cuda, state, case):
    """K5 and K6 bit for bit against the plain versions. The cases reach
    K5's tiles (32 samples) and level groups and K6's tiles, rounds and
    chunks: samples along rays (neighbours share cells), two volumes
    alternating at the same points and floors, n = 32k +- 1, a whole tile
    of zero gradient, many tiles and level groups in flight, n = 0, NaN
    and +-inf in g."""
    rng = np.random.RandomState(CARD_CASES.index(case))
    n = {"n1": 1, "n33": 33, "n5000": 5000, "tile_tail": 32 * 47 + 1,
         "many_blocks": 100_003, "n0": 0}.get(case, 2048)
    pts, vol, g = inputs(20 + CARD_CASES.index(case), n)
    feat, prim, bias = (t.to(cuda) for t in port(*state))
    if case == "one_cell":
        pts = (np.float32([0.31, 0.62, 0.27]) + rng.rand(n, 3) * 1e-7).astype(np.float32)
    if case == "zero_rows":
        g[rng.rand(n) < 0.5] = 0.0
    if case in ("ray_ordered", "zero_tile", "tile_tail"):
        pts = ray_points(rng, 4, n // 4 + 1, 2e-4)[:n]
        vol = np.repeat(rng.randint(0, NV, 4), n // 4 + 1)[:n].astype(np.int32)
    if case == "zero_tile":
        g[32:64] = 0.0
    if case == "nan_inf":
        g = special_g(g, rng)
    if case == "two_volumes":
        # volumes 0 and 1 share their bias, so a point's floors are equal in
        # both, while their primes (so their corners) differ
        bias = bias.clone()
        bias[:, 1] = bias[:, 0]
        pts = np.repeat(ray_points(rng, 2, 512, 2e-4), 2, axis=0)
        vol = np.tile(np.int32([0, 1]), pts.shape[0] // 2)
    if case == "tile_tail":            # n = 32k - 1 here, 32k + 1 below
        check_kernels(cuda, feat, prim, bias, pts[:-2], vol[:-2], g[:-2])
    check_kernels(cuda, feat, prim, bias, pts, vol, g[:pts.shape[0]])


LARGE_CASES = ["uniform", "skew", "n2e20", "l2t20"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", LARGE_CASES)
def test_k6_matches_plain_on_card_at_scale(cuda, case):
    """K6 bit for bit its plain version and a repeat at the shapes the
    training step gives it and beyond: 393,216 uniform samples at
    log2_table_size 19 (431 volumes, a random one a sample, g ~ N(0, 1)),
    2^18 samples in one cell a level (each level's 8 entries hold every
    record: 128 chunks a bucket), 2^20 samples, and log2_table_size 20."""
    gen = torch.Generator(device=cuda).manual_seed(LARGE_CASES.index(case))
    n = {"skew": 1 << 18, "n2e20": 1 << 20}.get(case, 393216)
    l2t = 20 if case == "l2t20" else 19
    _, prim, bias = the.init_hash_state(torch.Generator().manual_seed(3), 4, 431,
                                        device=cuda)
    pts = torch.rand((n, 3), generator=gen, device=cuda)
    vol = torch.randint(0, 431, (n,), generator=gen, device=cuda).to(torch.int32)
    g = torch.randn((n, NL * NC), generator=gen, device=cuda)
    if case == "skew":
        pts = torch.tensor([0.31, 0.62, 0.27], device=cuda) + pts * 1e-7
        vol = torch.full_like(vol, 7)
    check_k6(g, prim, bias, pts, vol, l2t)
