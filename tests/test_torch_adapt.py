"""Inner SGD and vision losses of the PyTorch port vs the JAX package
(``exploring_meta_tpu.adapt.maml.inner_sgd``, ``ops.losses``).

Same numpy inputs on both sides; a two-layer MLP stands in for the model
so that first- and second-order paths stay fast. Tolerance 1e-5 (f32,
a few small matmuls).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_meta_tpu.adapt import maml as jm
from exploring_meta_tpu.models import layers as jl
from exploring_meta_tpu.ops import losses as jloss
from exploring_meta_tpu_torch.adapt import maml as tm
from exploring_meta_tpu_torch.models import layers as tl
from exploring_meta_tpu_torch.ops import losses as tloss

WAYS, N, D, H = 5, 10, 6, 8


def _problem(seed, b=None):
    rng = np.random.default_rng(seed)
    lead = () if b is None else (b,)
    params = [{"w": (rng.normal(size=(D, H)) * 0.5).astype(np.float32),
               "b": (rng.normal(size=(H,)) * 0.1).astype(np.float32)},
              {"w": (rng.normal(size=(H, WAYS)) * 0.5).astype(np.float32),
               "b": np.zeros(WAYS, np.float32)}]
    x = rng.normal(size=lead + (N, D)).astype(np.float32)
    y = rng.integers(0, WAYS, size=lead + (N,)).astype(np.int32)
    return params, x, y


def _jax_loss(p, batch):
    x, y = batch
    return jloss.cross_entropy(jl.mlp_apply(p, x, jax.nn.relu), y)


def _torch_loss(p, batch):
    x, y = batch
    return tloss.cross_entropy(tl.mlp_apply(p, x, torch.relu), y).sum()


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _close(got, want, tol=1e-5):
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=tol, atol=tol)


def test_losses_match_jax_per_task():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, N, WAYS)).astype(np.float32)
    labels = rng.integers(0, WAYS, size=(3, N)).astype(np.int32)
    for fn_t, fn_j in ((tloss.cross_entropy, jloss.cross_entropy),
                       (tloss.accuracy, jloss.accuracy)):
        got = fn_t(torch.from_numpy(logits), torch.from_numpy(labels))
        want = jax.vmap(fn_j)(jnp.asarray(logits), jnp.asarray(labels))
        assert got.shape == (3,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("first_order", [True, False])
def test_inner_sgd_matches_jax(first_order):
    params, x, y = _problem(1)
    mask = [{"w": False, "b": False}, {"w": True, "b": True}]
    for trainable in (None, mask):
        want = jm.inner_sgd(_jax_loss, jax.tree_util.tree_map(jnp.asarray,
                                                             params),
                            (jnp.asarray(x), jnp.asarray(y)), 0.5, 2,
                            first_order=first_order, trainable=trainable)
        got = tm.inner_sgd(_torch_loss, _to_torch(params),
                           (torch.from_numpy(x), torch.from_numpy(y)), 0.5, 2,
                           first_order=first_order, trainable=trainable)
        _close(got, want)
        if trainable is not None:       # the frozen body did not move
            _close(got[0], params[0], tol=0)


@pytest.mark.parametrize("first_order", [True, False])
def test_meta_gradient_through_inner_sgd_matches_jax(first_order):
    """d(query loss of the adapted params)/d(initial params): second order
    with ``first_order=False`` (create_graph), first order otherwise."""
    params, x, y = _problem(2)
    _, qx, qy = _problem(3)

    def jmeta(p):
        a = jm.inner_sgd(_jax_loss, p, (jnp.asarray(x), jnp.asarray(y)),
                         0.05, 1, first_order=first_order)
        return _jax_loss(a, (jnp.asarray(qx), jnp.asarray(qy)))

    want = jax.grad(jmeta)(jax.tree_util.tree_map(jnp.asarray, params))
    tp = jax.tree_util.tree_map(lambda t: t.requires_grad_(),
                                _to_torch(params))
    adapted = tm.inner_sgd(_torch_loss, tp,
                           (torch.from_numpy(x), torch.from_numpy(y)), 0.05, 1,
                           first_order=first_order)
    meta = _torch_loss(adapted, (torch.from_numpy(qx), torch.from_numpy(qy)))
    got = torch.autograd.grad(meta, jax.tree_util.tree_leaves(tp))
    for a, b in zip(got, jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


def test_batched_tasks_adapt_on_their_own_support_only():
    """Params expanded to [B, ...] and the sum of per-task losses: task b's
    adapted params equal JAX's vmap of inner_sgd over the tasks."""
    params, x, y = _problem(4, b=3)
    want = jax.vmap(lambda xx, yy: jm.inner_sgd(
        _jax_loss, jax.tree_util.tree_map(jnp.asarray, params), (xx, yy),
        0.5, 2, first_order=True))(jnp.asarray(x), jnp.asarray(y))
    per_task = jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(a)).expand((3,) + a.shape)
        .contiguous(), params)
    got = tm.inner_sgd(_torch_loss, per_task,
                       (torch.from_numpy(x), torch.from_numpy(y)), 0.5, 2,
                       first_order=True)
    _close(got, want)


def test_tree_where_selects_per_leaf():
    a = {"u": torch.ones(2), "v": [torch.zeros(3)]}
    b = {"u": torch.full((2,), 5.0), "v": [torch.full((3,), 7.0)]}
    out = tm.tree_where({"u": True, "v": [False]}, a, b)
    torch.testing.assert_close(out["u"], a["u"])
    torch.testing.assert_close(out["v"][0], b["v"][0])
