"""The port's fused Adam (kernel K1's plain version on the CPU) against the
JAX package: its ``apply_adam``, whose Pallas kernel runs in interpret mode
on the CPU as tests/test_fused_adam.py runs it, and the production optax
chain (trainer.make_optimizer).

Same tree shapes as tests/test_fused_adam.py, 3 steps. Tolerance rtol 1e-6
/ atol 1e-7: the same f32 operations in the same order on both sides; the
bias corrections c1/c2 come from f32 pow, which may differ by an ulp
between XLA and torch.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from f2nerf_tpu.ops.fused_adam import apply_adam as jax_apply_adam
from f2nerf_tpu.train.trainer import make_optimizer
from f2nerf_torch.ops import fused_adam as tfa
from f2nerf_torch.train.trainer import ADAM_KW, WEIGHT_DECAY
from f2nerf_torch.utils.convert import convert_state
from f2nerf_torch.utils.tree import named_leaves

STEPS = 3
LR = 1e-2


def small_tree(key):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return dict(
        feat_pool=jax.random.normal(k1, (16, 32, 128)) * 1e-2,
        field_mlp=[jax.random.normal(k2, (32, 64)), jax.random.normal(k3, (64, 16))],
        app_emb=jax.random.normal(k4, (7, 16)) * 0.1,
    )


def rand_like(tree, key):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    keys = jax.random.split(key, len(leaves))
    return jax.tree_util.tree_unflatten(
        treedef, [jax.random.normal(k, l.shape) * 1e-3 for k, l in zip(keys, leaves)])


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_state(params_j, st_j):
    adam = st_j[1]
    return convert_state(to_np(params_j),
                         dict(count=np.asarray(adam.count), mu=to_np(adam.mu),
                              nu=to_np(adam.nu)),
                         dict(prim_pool=np.zeros((1, 1, 3), np.uint32),
                              bias_pool=np.zeros((1, 1, 3), np.float32)))[:2]


def port_grads(g_j):
    return jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)), g_j)


@pytest.fixture(scope="module")
def runs():
    """STEPS updates by the optax chain, the JAX fused path and the port."""
    tx = make_optimizer()
    p_chain = small_tree(jax.random.PRNGKey(0))
    st_chain = tx.init(p_chain)
    p_fused, st_fused = p_chain, st_chain
    p_t, o_t = port_state(p_chain, st_chain)
    for i in range(STEPS):
        g = rand_like(p_chain, jax.random.PRNGKey(100 + i))
        upd, st_chain = tx.update(g, st_chain, p_chain)
        p_chain = optax.apply_updates(p_chain, jax.tree_util.tree_map(lambda u: -LR * u, upd))
        p_fused, st_fused = jax_apply_adam(p_fused, st_fused, g, LR,
                                           weight_decay=WEIGHT_DECAY, **ADAM_KW)
        tfa.apply_adam(p_t, o_t, port_grads(g), LR, torch.tensor(True),
                       weight_decay=WEIGHT_DECAY, **ADAM_KW)
    return dict(chain=(p_chain, st_chain), fused=(p_fused, st_fused), port=(p_t, o_t))


@pytest.mark.parametrize("ref", ["chain", "fused"])
def test_params_match(runs, ref):
    p_ref = runs[ref][0]
    p_t = runs["port"][0]
    for (name, a), (_, b) in zip(named_leaves(p_t), named_leaves(to_np(p_ref))):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-6, atol=1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("ref", ["chain", "fused"])
def test_moments_and_count_match(runs, ref):
    adam = runs[ref][1][1]
    o_t = runs["port"][1]
    assert int(o_t["count"]) == int(adam.count) == STEPS
    for k, ref_tree in (("mu", adam.mu), ("nu", adam.nu)):
        for (name, a), (_, b) in zip(named_leaves(o_t[k]), named_leaves(to_np(ref_tree))):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-9,
                                       err_msg=f"{k}{name}")


def test_skipped_update_leaves_state_untouched():
    """finite=False: no param, moment or count changes (the JAX step's
    lax.cond skip branch), decided on the device without a host sync."""
    tx = make_optimizer()
    p_j = small_tree(jax.random.PRNGKey(1))
    p_t, o_t = port_state(p_j, tx.init(p_j))
    g = port_grads(rand_like(p_j, jax.random.PRNGKey(2)))
    before = [t.detach().clone() for _, t in named_leaves(p_t)]
    tfa.apply_adam(p_t, o_t, g, LR, torch.tensor(False),
                   weight_decay=WEIGHT_DECAY, **ADAM_KW)
    assert int(o_t["count"]) == 0
    for a, (_, b) in zip(before, named_leaves(p_t)):
        assert torch.equal(a, b.detach())
    for _, m in named_leaves(o_t["mu"]):
        assert not m.any()
    # then a real step advances the count to 1 and leaves the pool decay-free
    tfa.apply_adam(p_t, o_t, g, LR, torch.tensor(True),
                   weight_decay=WEIGHT_DECAY, **ADAM_KW)
    assert int(o_t["count"]) == 1
    g0 = g["feat_pool"]
    mhat = (1 - ADAM_KW["b1"]) * g0 / (1 - ADAM_KW["b1"])
    vhat = (1 - ADAM_KW["b2"]) * g0 * g0 / (1 - ADAM_KW["b2"])
    expect = before[1] - LR * mhat / (torch.sqrt(vhat) + ADAM_KW["eps"])
    np.testing.assert_allclose(p_t["feat_pool"].detach().numpy(), expect.numpy(),
                               rtol=1e-6, atol=1e-8)


def test_wrapper_refuses_other_devices():
    """Only CPU tensors take the plain version; anything else launches the
    kernel (CUDA) or raises."""
    t = torch.zeros(8, device="meta")
    flag = torch.ones((), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        tfa.fused_adam(t, t, t, t, torch.zeros(3, device="meta"), flag,
                       wd=0.0, **ADAM_KW)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("wd", [0.0, WEIGHT_DECAY])
def test_kernel_matches_plain_on_card(cuda, wd):
    gen = torch.Generator(device=cuda).manual_seed(0)
    leaf = [torch.randn((16, 512, 128), generator=gen, device=cuda) * s
            for s in (1e-2, 1e-3, 1e-3, 1e-3)]
    leaf[2] = leaf[2].abs()
    scal = torch.tensor([1e-2, 10.0, 30.0], device=cuda)
    yes = torch.ones((), dtype=torch.bool, device=cuda)
    a = [t.clone() for t in leaf]
    b = [t.clone() for t in leaf]
    before = tfa.fused_adam.launches
    tfa.fused_adam(*a, scal, yes, wd=wd, **ADAM_KW)
    tfa.adam_leaf_plain(*b, scal, yes, wd=wd, **ADAM_KW)
    assert tfa.fused_adam.launches == before + 1
    for x, y in zip(a[:3], b[:3]):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)
