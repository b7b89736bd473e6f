"""The port's lockstep marcher (K7's plain version, ``ray_march_plain``)
against the JAX package's ``ray_march`` on the JAX-built tree of
tests/test_torch_sampler.py, with the same hits and the same noise.

Tolerances: against JAX run op by op (``jax.disable_jit``, the same
per-operation rounding) the sample counts and nodes must be equal and the
sample positions and warp-space steps agree to 1e-5. A batch marched at
once and its rays marched one by one (the property K7's warp per ray
rests on: no ray reads another's state) are held equal exactly, with the
same per-ray iteration counts. Kernel cases (``cuda`` marker, skipped
without a card): K7 against the plain version, n_s and out_node equal,
out_t/out_dt to 1e-6 relative; and the warp-per-ray cases (ray counts,
empty rays, hit chunks, sample chunks, a subdivided tree), all four
outputs equal.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f2nerf_tpu.sampler import device as jdv
from f2nerf_tpu.sampler import octree as joc
from f2nerf_torch.sampler import device as tdv
from f2nerf_torch.utils.convert import octree_from_fields
from test_sampler import CFG, synthetic_rig

CAPS = (4096, 512, 65536)
MAX_S = 64
SAMPLE_L = 1.0 / 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's own intra-op
    pool would oversubscribe the cores, and these are small ops that gain
    nothing from it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(x):
    return torch.from_numpy(np.array(x, copy=True))


SUB_CAPS = (16384, 512, 65536)


@pytest.fixture(scope="module")
def trees():
    c2w, w2c, intri, bounds = synthetic_rig()
    host = joc.build_octree(c2w, w2c, intri, bounds, CFG, seed=0)
    return host, jdv.to_device_tree(host, *CAPS), tdv.to_device_tree(octree_from_fields(host), *CAPS)


@pytest.fixture(scope="module")
def sub_host(trees):
    """The rig's tree after two brute-force subdivisions (as
    tests/test_torch_maintain.py builds one): 10,545 nodes, up to 45 hits
    a ray, a new leaf at every hit."""
    t = copy.deepcopy(trees[0])
    for _ in range(2):
        t = joc._proc_octree_np(t, True, True, True)
    return octree_from_fields(t)


def rays(seed, n, spread=2.0):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, np.full(n, 0.05, np.float32), np.full(n, 1e8, np.float32)


def hits_of(ttree, o, d, near, far, max_hits=32):
    return [x.numpy() for x in tdv.traverse(ttree, T(o), T(d), T(near), T(far),
                                            max_hits=max_hits)[:4]]


def noise_of(kind, n):
    if kind == "ones":
        return np.ones(n + MAX_S + 16, np.float32)
    u = np.random.RandomState(n).rand(n + MAX_S + 16).astype(np.float32)
    # a training draw (U[0,1) - 0.5 + 1) times a fineness of 2
    return (((u - np.float32(0.5)) + np.float32(1.0)) * np.float32(2.0)).astype(np.float32)


@pytest.mark.parametrize("scale_by_dis", [False, True])
@pytest.mark.parametrize("noise_kind", ["ones", "random"])
def test_ray_march_matches_jax_op_by_op(trees, scale_by_dis, noise_kind):
    _, jtree, ttree = trees
    o, d, near, far = rays(4, 16)
    hits = hits_of(ttree, o, d, near, far)
    noise = noise_of(noise_kind, 16)
    with jax.disable_jit():
        want = [np.asarray(x) for x in jdv.ray_march(
            jtree, jnp.asarray(o), jnp.asarray(d), *map(jnp.asarray, hits),
            jnp.asarray(noise), SAMPLE_L, scale_by_dis, MAX_S)]
    got = [x.numpy() for x in tdv.ray_march(
        ttree, T(o), T(d), *map(T, hits), T(noise), SAMPLE_L, scale_by_dis, MAX_S)]
    assert (want[3] > 0).sum() >= 8
    np.testing.assert_array_equal(got[3], want[3])          # n_samples
    np.testing.assert_array_equal(got[2], want[2])          # out_node
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)   # out_t
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-7)   # out_dt
    np.testing.assert_array_equal(got[4], want[4])          # first_oct


def test_ray_march_saturates_like_jax(trees):
    """A small max_s cuts rays at max_s samples; max_iters bounds the loop:
    both exactly as the JAX loop does."""
    _, jtree, ttree = trees
    o, d, near, far = rays(6, 16)
    hits = hits_of(ttree, o, d, near, far)
    noise = noise_of("random", 16)[:16 + 24 + 16]
    for max_s, max_iters in ((24, 0), (64, 30)):
        with jax.disable_jit():
            want = [np.asarray(x) for x in jdv.ray_march(
                jtree, jnp.asarray(o), jnp.asarray(d), *map(jnp.asarray, hits),
                jnp.asarray(np.resize(noise, 16 + max_s + 16)), SAMPLE_L, True,
                max_s, max_iters)]
        got = [x.numpy() for x in tdv.ray_march_plain(
            ttree, T(o), T(d), *map(T, hits), T(np.resize(noise, 16 + max_s + 16)),
            SAMPLE_L, True, max_s, max_iters)]
        np.testing.assert_array_equal(got[3], want[3])
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
        if max_s == 24:
            assert (want[3] == 24).any()


def test_ray_march_uniform_steps(trees):
    """The JAX suite's property (tests/test_sampler.py:180-214): with
    noise == 1 the warp-space step equals sample_l, t increases, and every
    sample lies inside one of its ray's hits."""
    _, _, ttree = trees
    o, d, near, far = rays(3, 16)
    hi, hn, hf, nh = hits_of(ttree, o, d, near, far, max_hits=64)
    out_t, out_dt, out_node, n_s, _ = (x.numpy() for x in tdv.ray_march(
        ttree, T(o), T(d), T(hi), T(hn), T(hf), T(nh),
        torch.ones(16 + 256 + 16), SAMPLE_L, False, 256))
    assert (n_s > 0).any()
    for r in range(16):
        k = n_s[r]
        if k == 0:
            continue
        np.testing.assert_allclose(out_dt[r, :k], SAMPLE_L, rtol=1e-4)
        assert (np.diff(out_t[r, :k]) > 0).all()
        assert (out_node[r, :k] >= 0).all() and (out_node[r, k:] == -1).all()
        for s in range(k):
            j = list(hi[r, :nh[r]]).index(out_node[r, s])
            assert hn[r, j] - 1e-3 <= out_t[r, s] <= hf[r, j] + 1e-3


@pytest.mark.parametrize("tree_kind,scale_by_dis,max_s,max_iters", [
    ("rig", True, 64, 0), ("subdivided", False, 33, 0), ("subdivided", True, 96, 40)])
def test_batch_equals_rays_marched_alone(trees, sub_host, monkeypatch, tree_kind,
                                         scale_by_dis, max_s, max_iters):
    """Marching a batch gives the four outputs of marching each ray alone
    (its hit row, its noise from offset r) and concatenating; each ray's
    EMIT/ADVANCE counts are its lone run's, and their sum is that run's
    loop passes (one warp Jacobian a pass). This is what lets K7 run each
    ray in a warp of its own."""
    ttree = trees[2] if tree_kind == "rig" else tdv.to_device_tree(sub_host, *SUB_CAPS)
    R = 12
    o, d, near, far = rays(5, R)
    hi, hn, hf, nh = hits_of(ttree, o, d, near, far, max_hits=64)
    nh = nh.copy()
    nh[7] = 0
    noise = noise_of("random", R)[:R + max_s + 16]
    whole = tdv.ray_march_plain(ttree, T(o), T(d), T(hi), T(hn), T(hf), T(nh), T(noise),
                                SAMPLE_L, scale_by_dis, max_s, max_iters)
    iters = tdv.ray_march_plain.last_iters
    assert tuple(iters.shape) == (R, 2) and int(iters[7].sum()) == 0
    passes = [0]
    real_jac = tdv.warp_jac_dir

    def counted_jac(*a):
        passes[0] += 1
        return real_jac(*a)

    monkeypatch.setattr(tdv, "warp_jac_dir", counted_jac)
    alone = []
    for r in range(R):
        passes[0] = 0
        sl = slice(r, r + 1)
        alone.append(tdv.ray_march_plain(
            ttree, T(o[sl]), T(d[sl]), T(hi[sl]), T(hn[sl]), T(hf[sl]), T(nh[sl]),
            T(noise[r:]), SAMPLE_L, scale_by_dis, max_s, max_iters))
        one = tdv.ray_march_plain.last_iters
        assert torch.equal(one[0], iters[r])
        assert int(one.sum()) == passes[0]
    for k in range(5):
        assert torch.equal(whole[k], torch.cat([a[k] for a in alone])), k
    assert int(whole[3].sum()) > 0 and int(iters[:, 1].sum()) > 0
    if max_iters:
        assert int(iters.sum(dim=1).max()) == max_iters     # the cut is reached


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scale_by_dis,noise_kind,max_s", [
    (False, "ones", 96), (True, "random", 96), (True, "random", 8)])
def test_kernel_matches_plain_on_card(cuda, trees, scale_by_dis, noise_kind, max_s):
    """K7 against the plain version on the card: n_s and out_node equal,
    out_t/out_dt to 1e-6 relative, one launch."""
    _, _, ttree = trees
    dtree = tdv.to_device_tree(octree_from_fields(trees[0]), *CAPS, device=cuda)
    o, d, near, far = rays(9, 300)
    hits = [T(h).to(cuda) for h in hits_of(ttree, o, d, near, far)]
    noise = T(np.resize(noise_of(noise_kind, 300), 300 + max_s + 16)).to(cuda)
    args = (dtree, T(o).to(cuda), T(d).to(cuda), *hits, noise, SAMPLE_L,
            scale_by_dis, max_s)
    before = tdv.ray_march.launches
    got = tdv.ray_march(*args)
    want = tdv.ray_march_plain(*args)
    assert tdv.ray_march.launches == before + 1
    assert torch.equal(got[3], want[3]) and torch.equal(got[2], want[2])
    for k in (0, 1):
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=0)
    assert torch.equal(got[4], want[4])


# the warp-per-ray layout's edges: R (1, 5, and 300, not a multiple of the
# rays a block), rays with no hits, a hit cap of 1 and one past a 32-entry
# chunk, max_s below, just past and beyond a 32-sample chunk, a subdivided
# tree (a new leaf at every hit), scale_by_dis both ways
CARD_CASES = [  # tree, R, hit cap, max_s, scale_by_dis, noise, rays without hits
    ("rig", 1, 32, 96, True, "random", False),
    ("rig", 5, 32, 33, False, "ones", False),
    ("rig", 300, 32, 8, True, "random", False),
    ("rig", 300, 32, 96, False, "ones", True),
    ("rig", 300, 1, 33, True, "random", False),
    ("subdivided", 300, 64, 96, True, "random", False),
    ("subdivided", 300, 64, 33, False, "random", True),
    ("subdivided", 5, 64, 96, False, "ones", False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_kernel_cases_on_card(cuda, trees, sub_host, case):
    """K7 against the plain version on the card: all four outputs equal,
    one launch."""
    kind, R, max_hits, max_s, scale_by_dis, noise_kind, empty = case
    host = octree_from_fields(trees[0]) if kind == "rig" else sub_host
    caps = CAPS if kind == "rig" else SUB_CAPS
    dtree = tdv.to_device_tree(host, *caps, device=cuda)
    o, d, near, far = rays(9, R)
    hits = hits_of(tdv.to_device_tree(host, *caps), o, d, near, far, max_hits=max_hits)
    if empty:
        hits[3] = hits[3].copy()
        hits[3][::3] = 0
    assert hits[0].shape[1] == max_hits
    if max_hits > 32 and R > 5:
        assert (hits[3] > 32).any()
    hits = [T(h).to(cuda) for h in hits]
    noise = T(np.resize(noise_of(noise_kind, R), R + max_s + 16)).to(cuda)
    args = (dtree, T(o).to(cuda), T(d).to(cuda), *hits, noise, SAMPLE_L,
            scale_by_dis, max_s)
    before = tdv.ray_march.launches
    got = tdv.ray_march(*args)
    want = tdv.ray_march_plain(*args)
    assert tdv.ray_march.launches == before + 1
    for k in range(4):
        assert torch.equal(got[k], want[k]), k
    if max_s > 32 and R > 5:
        assert int(want[3].max()) > 32
