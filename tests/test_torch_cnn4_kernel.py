"""Fused CNN4 block of the PyTorch port vs the JAX Pallas kernels.

The port's plain twins (the CPU path of the CUDA kernels'
wrappers) are held against the four JAX call sites
(``_blk_fwd_call_single``, ``_blk_bwd_call_single``,
``_blk_fwd_pallas_batched``, ``_blk_bwd_pallas_batched``), run in
interpret mode on the CPU, at all four block shapes (28 -> 14 -> 7 -> 4
-> 2), and the port's ``fused_omni_base`` against JAX's. Same numpy
inputs on both sides; tolerances as tests/test_pallas_cnn4.py states
them: forward 2e-5, gradients rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_meta_tpu.pallas import cnn4_pallas as jp
from exploring_meta_tpu_torch.cuda import cnn4_cuda as tc
from exploring_meta_tpu_torch.models.cnn4 import base_apply
from exploring_meta_tpu_torch.utils.tree import tree_items

HIDDEN = 8
N = 3
B = 2
# (H, Ci) of the four Omniglot blocks at the narrow test width
BLOCKS = [(28, 1), (14, HIDDEN), (7, HIDDEN), (4, HIDDEN)]


def _block_inputs(seed, h, ci, b=None):
    rng = np.random.default_rng(seed)
    lead = () if b is None else (b,)
    x = rng.normal(size=lead + (N, h, h, ci)).astype(np.float32)
    w = (rng.normal(size=lead + (3, 3, ci, HIDDEN)) * 0.3).astype(np.float32)
    bb = (rng.normal(size=lead + (HIDDEN,)) * 0.1).astype(np.float32)
    s = rng.uniform(0.2, 1.0, size=lead + (HIDDEN,)).astype(np.float32)
    be = (rng.normal(size=lead + (HIDDEN,)) * 0.1).astype(np.float32)
    ho = tc.out_hw(h)
    g = rng.normal(size=lead + (N, ho, ho, HIDDEN)).astype(np.float32)
    return x, (w, bb, s, be), g


def _t(a, batch=False):
    t = torch.from_numpy(np.asarray(a))
    return t if batch else t.unsqueeze(0)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _port_bwd(x, p4, g):
    dy, dw, db, ds, dbe = tc.block_bwd_params(x, *p4, g)
    dx = tc.block_bwd_input(dy, p4[0], x.shape[2], x.shape[3])
    return dw, db, ds, dbe, dx


def _check_grads(got, want):
    """(dw, db, dscale, dbias, dx) at rtol 1e-4 / atol 1e-5. The conv bias
    grad db = sum(dy) is zero in exact arithmetic (BN removes the mean of
    dy), so both sides hold only f32 rounding noise of order
    eps * N*Ho*Wo * |dy|: each is checked to be that small instead."""
    for i, (a, b) in enumerate(zip(got, want)):
        if i == 1:
            assert np.abs(np.asarray(a)).max() < 1e-4
            assert np.abs(np.asarray(b)).max() < 1e-4
        else:
            _close(a, b, 1e-4, 1e-5)


@pytest.mark.parametrize("blk", range(4))
def test_single_task_block_matches_pallas(blk):
    h, ci = BLOCKS[blk]
    x, p4, g = _block_inputs(blk, h, ci)
    want = jp._blk_fwd_call_single(tuple(map(jnp.asarray, p4)), jnp.asarray(x))
    got = tc.block_fwd(_t(x), *(_t(p) for p in p4))[0]
    _close(got, want, 2e-5, 2e-5)
    want = jp._blk_bwd_call_single(tuple(map(jnp.asarray, p4)),
                                   jnp.asarray(x), jnp.asarray(g))
    got = _port_bwd(_t(x), [_t(p) for p in p4], _t(g))
    _check_grads([a[0] for a in got], want)


@pytest.mark.parametrize("blk", range(4))
def test_batched_block_matches_pallas(blk):
    h, ci = BLOCKS[blk]
    x, p4, g = _block_inputs(10 + blk, h, ci, b=B)
    want = jp._blk_fwd_pallas_batched(tuple(map(jnp.asarray, p4)),
                                      jnp.asarray(x))
    got = tc.block_fwd(_t(x, True), *(_t(p, True) for p in p4))
    _close(got, want, 2e-5, 2e-5)
    want = jp._blk_bwd_pallas_batched(tuple(map(jnp.asarray, p4)),
                                      jnp.asarray(x), jnp.asarray(g))
    got = _port_bwd(_t(x, True), [_t(p, True) for p in p4], _t(g, True))
    _check_grads(got, want)


def _base_params(seed):
    rng = np.random.default_rng(seed)
    blocks, ci = [], 1
    for _ in range(4):
        blocks.append({
            "conv": {"w": (rng.normal(size=(3, 3, ci, HIDDEN)) * 0.4
                           ).astype(np.float32),
                     "b": (rng.normal(size=(HIDDEN,)) * 0.1).astype(np.float32)},
            "bn": {"scale": rng.uniform(0.2, 1.0, HIDDEN).astype(np.float32),
                   "bias": (rng.normal(size=(HIDDEN,)) * 0.1
                            ).astype(np.float32)}})
        ci = HIDDEN
    head_w = rng.normal(size=(HIDDEN, 5)).astype(np.float32)
    x = rng.normal(size=(5, 28, 28, 1)).astype(np.float32)
    return blocks, head_w, x


def _torch_tree(tree, requires_grad=False):
    return jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(a), requires_grad=requires_grad),
        tree)


def test_fused_omni_base_forward_and_grads_match_jax():
    blocks, head_w, x = _base_params(0)
    y = np.arange(5) % 5
    jb = jax.tree_util.tree_map(jnp.asarray, blocks)

    def jloss(bl, xx):
        logits = jp.fused_omni_base(bl, xx) @ head_w
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(logp[jnp.arange(5), y])

    want_f = jp.fused_omni_base(jb, jnp.asarray(x))
    want_gb, want_gx = jax.grad(jloss, argnums=(0, 1))(jb, jnp.asarray(x))

    tb = _torch_tree(blocks, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    feats = tc.fused_omni_base(tb, tx)
    _close(feats.detach(), want_f, 2e-5, 2e-5)
    loss = torch.nn.functional.cross_entropy(feats @ torch.from_numpy(head_w),
                                             torch.from_numpy(y))
    leaves = jax.tree_util.tree_leaves(tb)
    grads = torch.autograd.grad(loss, leaves + [tx])
    for a, b in zip(grads[:-1], jax.tree_util.tree_leaves(want_gb)):
        _close(a, b, 1e-4, 1e-5)
    _close(grads[-1], want_gx, 1e-4, 1e-5)


def test_fused_omni_base_per_task_params_match_jax_vmap():
    blocks, _, x = _base_params(1)
    xb = np.stack([x, x[::-1] * 0.5])
    pb = jax.tree_util.tree_map(lambda p: np.stack([p, p * 1.01]), blocks)
    want = jax.vmap(jp.fused_omni_base)(
        jax.tree_util.tree_map(jnp.asarray, pb), jnp.asarray(xb))
    got = tc.fused_omni_base(_torch_tree(pb), torch.from_numpy(xb))
    _close(got, want, 2e-5, 2e-5)


def test_create_graph_on_fused_path_matches_direct():
    """Second order through ``FusedBlock`` (its backward under
    ``create_graph=True`` is ``FusedBlockBackward``): one inner SGD step on
    the base, then the gradient of a loss at the adapted params, against
    the port's per-op base and JAX's plain ``_pure_base``. rtol 3e-4 / atol
    3e-5 x max|grad| (inner_lr 0.05); the conv-bias grads by magnitude."""
    blocks, head_w, x = _base_params(2)
    y = np.arange(5) % 5
    xq = x[::-1].copy()

    def jce(logits):
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(5), y])

    def jmeta(bl):
        g = jax.grad(lambda b: jce(jp._pure_base(b, jnp.asarray(x)) @ head_w))(bl)
        fast = jax.tree_util.tree_map(lambda p, d: p - 0.05 * d, bl, g)
        return jce(jp._pure_base(fast, jnp.asarray(xq)) @ head_w)

    want = jax.jit(jax.grad(jmeta))(jax.tree_util.tree_map(jnp.asarray,
                                                           blocks))

    def tmeta(base):
        tb = _torch_tree(blocks, requires_grad=True)
        leaves = jax.tree_util.tree_leaves(tb)
        hw = torch.from_numpy(head_w)

        def ce(bl, im):
            return torch.nn.functional.cross_entropy(base(bl, im) @ hw,
                                                     torch.from_numpy(y))
        g = torch.autograd.grad(ce(tb, torch.from_numpy(x)), leaves,
                                create_graph=True)
        fast = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(blocks),
            [p - 0.05 * d for p, d in zip(leaves, g)])
        return torch.autograd.grad(ce(fast, torch.from_numpy(xq)), leaves)

    got = tmeta(tc.fused_omni_base)
    direct = tmeta(lambda bl, im: base_apply(bl, im, False).mean(dim=(1, 2)))
    keys = [k for k, _ in tree_items(blocks)]
    for key, a, d, w in zip(keys, got, direct,
                            jax.tree_util.tree_leaves(want)):
        w = np.asarray(w)
        if key.endswith("conv/b"):  # zero in exact arithmetic
            for t in (a.numpy(), d.numpy(), w):
                assert np.abs(t).max() < 1e-5, key
            continue
        lim = dict(rtol=3e-4, atol=3e-5 * np.abs(w).max())
        _close(a, w, **lim)
        _close(a, d.numpy(), **lim)


def test_wrappers_refuse_devices_without_a_kernel():
    """No fallback: a tensor that is neither on the CPU nor on a card
    never reaches the plain twin."""
    x = torch.empty(1, 2, 28, 28, 1, device="meta")
    p = [torch.empty(s, device="meta")
         for s in ((1, 3, 3, 1, 4), (1, 4), (1, 4), (1, 4))]
    with pytest.raises(RuntimeError, match="unsupported device"):
        tc.block_fwd(x, *p)


def _meta_block(b=1, n=2, h=28, ci=1, co=4, dtype=torch.float32):
    def t(*shape):
        return torch.empty(shape, dtype=dtype, device="meta")
    return t(b, n, h, h, ci), t(b, 3, 3, ci, co), t(b, co), t(b, co), t(b, co)


@pytest.mark.parametrize("args,match", [
    (dict(b=tc.MAX_TASKS + 1), "tasks in one launch"),
    (dict(dtype=torch.float16), "unsupported dtype"),
])
def test_launch_checks_refuse_what_the_kernels_do_not_take(args, match):
    """What a launch would refuse (or a wrong dtype) raises before it."""
    with pytest.raises(ValueError, match=match):
        tc._check(*_meta_block(**args))
    assert tc._check(*_meta_block()) == (1, 2, 28, 28, 1, 4)


def test_launch_checks_take_1000_images_per_task():
    """No kernel holds a whole task on chip, so only device memory limits
    the images per task (block 1: once 295 at most)."""
    assert tc._check(*_meta_block(n=1000)) == (1, 1000, 28, 28, 1, 4)


def test_bwd_params_workspace_floats():
    """The scratch of ``cnn4_block_bwd_params`` (mirrors
    ``launch_bwd_params``): tile and task pairs and y, plus the dw
    partials where the positions are split (block 1 of a served batch:
    9 chunks; block 2: one); in bf16 also dy's three bf16 terms, half a
    float each."""
    b, co = 64, 64
    m1, m2 = 25 * 14 * 14, 25 * 7 * 7
    assert tc.dw_chunk(b, m1, 1, co) == 560
    assert -(-m1 // 560) == 9
    f32_1 = 2 * b * 77 * co + 4 * b * co + b * m1 * co + b * 9 * (9 * co + co)
    assert tc.bwd_params_workspace_floats(b, 25, 28, 28, 1, co) == f32_1
    assert tc.dw_chunk(b, m2, 64, co) == 1232        # one chunk of all M
    f32_2 = 2 * b * 20 * co + 4 * b * co + b * m2 * co
    assert tc.bwd_params_workspace_floats(b, 25, 14, 14, 64, co) == f32_2
    assert tc.bwd_params_workspace_floats(b, 0, 14, 14, 64, co) == 0
    assert tc.bwd_params_workspace_floats(
        b, 25, 28, 28, 1, co, torch.bfloat16) == f32_1 + 3 * b * m1 * co // 2
    assert tc.bwd_params_workspace_floats(
        b, 25, 14, 14, 64, co, torch.bfloat16) == f32_2 + 3 * b * m2 * co // 2
    assert tc.bwd_params_workspace_floats(1, 1, 4, 4, 64, 3,
                                          torch.bfloat16) == (
        2 * 3 + 4 * 3 + 4 * 3 + (3 * 4 * 3 + 1) // 2)


def test_plain_path_counts_no_launches():
    tc.reset_launch_counts()
    x, p4, _ = _block_inputs(3, 7, HIDDEN, b=1)
    tc.block_fwd(torch.from_numpy(x), *(torch.from_numpy(p) for p in p4))
    assert tc.launch_counts() == dict.fromkeys(tc.KERNELS, 0)
