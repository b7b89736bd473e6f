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
  * the pool gradient: to 1e-5 of its largest entry (scatter-adds summed
    in another order).
Kernel cases (``cuda`` marker, skipped without a card): K5 bit for bit and
K6 within 1e-5 of the largest entry against the plain versions.
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
              "two_volumes", "tile_tail", "zero_tile", "many_blocks", "n0"]


def ray_points(rng, n_rays, n_per_ray, step):
    """[n_rays * n_per_ray, 3] samples along rays, a ray's consecutive and
    `step` apart, inside [0, 1]^3: a tile's lanes share coarse cells."""
    o = rng.uniform(0.3, 0.7, (n_rays, 1, 3))
    d = rng.randn(n_rays, 1, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.arange(n_per_ray)[None, :, None] * step
    return (o + d * t).reshape(-1, 3).astype(np.float32)


def check_kernels(cuda, feat, prim, bias, pts, vol, g):
    """K5 bit for bit and K6 within 1e-5 of the largest entry against the
    plain versions, one launch each (none for n = 0)."""
    pts, vol, g = (torch.from_numpy(x).to(cuda) for x in (pts, vol, g))
    n0, n1 = the.hash_encode_fwd.launches, the.hash_encode_bwd.launches
    assert torch.equal(the.hash_encode_fwd(feat, prim, bias, pts, vol, L2T),
                       the.hash_encode_fwd_plain(feat, prim, bias, pts, vol, L2T))
    d_p = the.hash_encode_bwd_plain(g, prim, bias, pts, vol, L2T, feat.shape[0])
    d_k = the.hash_encode_bwd(g, prim, bias, pts, vol, L2T, feat.shape[0])
    torch.cuda.synchronize()
    assert float((d_k - d_p).abs().max()) <= 1e-5 * float(d_p.abs().max())
    one = int(pts.shape[0] > 0)
    assert (the.hash_encode_fwd.launches, the.hash_encode_bwd.launches) == (n0 + one, n1 + one)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernels_match_plain_on_card(cuda, state, case):
    """K5 bit for bit and K6 within 1e-5 of the largest entry against the
    plain versions. The cases reach the kernels' tiles (32 samples) and
    level groups: samples along rays (lanes merge on a shared cell), two
    volumes alternating at the same points and floors (no merge across
    volumes), n = 32k +- 1, a whole tile of zero gradient, many tiles and
    level groups in flight, n = 0."""
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
