"""Layers of the PyTorch port vs ``exploring_meta_tpu.models.layers``.

Same numpy inputs on both sides; the JAX layers run at their default
"highest" precision and the port's with TF32 off. Task-batched inputs
(``[B, N, H, W, C]``, per-task params) are held against ``jax.vmap`` of
the JAX layer, which is where per-task BN statistics come from there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_meta_tpu.models import layers as jl
from exploring_meta_tpu_torch.models import layers as tl

RTOL = ATOL = 2e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _conv_p(rng, ci, co, lead=()):
    return {"w": (rng.normal(size=lead + (3, 3, ci, co)) * 0.3).astype(np.float32),
            "b": rng.normal(size=lead + (co,)).astype(np.float32)}


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_precision_switch_sets_both_tf32_flags():
    try:
        tl.set_precision("high")
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        tl.set_precision("highest")
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        assert tl.get_precision() == "highest"
    finally:
        tl.set_precision("highest")
    with pytest.raises(ValueError):
        tl.set_precision("tf32")


def test_conv_impl_default_is_fused():
    assert tl.get_conv_impl() == "fused"
    with pytest.raises(ValueError):
        tl.set_conv_impl("pallas")


@pytest.mark.parametrize("stride,h", [(1, 9), (2, 9), (2, 8)])
def test_conv2d_matches_jax(stride, h):
    rng = _rng(stride * 10 + h)
    x = rng.normal(size=(2, h, h, 3)).astype(np.float32)
    p = _conv_p(rng, 3, 5)
    want = jl.conv2d(_j(p), jnp.asarray(x), stride=stride)
    _close(tl.conv2d(_t(p), torch.from_numpy(x), stride=stride), want)


@pytest.mark.parametrize("h", [28, 7, 4])
def test_s2d_equals_direct(h):
    rng = _rng(h)
    x = torch.from_numpy(rng.normal(size=(2, 3, h, h, 4)).astype(np.float32))
    for lead in ((), (2,)):
        p = _t(_conv_p(rng, 4, 6, lead))
        prev = tl.get_conv_impl()
        try:
            tl.set_conv_impl("direct")
            direct = tl.conv2d(p, x, stride=2)
            tl.set_conv_impl("s2d")
            s2d = tl.conv2d(p, x, stride=2)
        finally:
            tl.set_conv_impl(prev)
        _close(s2d, direct, 1e-5, 1e-5)


def test_per_task_conv_matches_jax_vmap():
    rng = _rng(1)
    x = rng.normal(size=(3, 2, 9, 9, 2)).astype(np.float32)
    p = _conv_p(rng, 2, 4, lead=(3,))
    want = jax.vmap(lambda pp, xx: jl.conv2d(pp, xx, stride=2))(_j(p),
                                                                jnp.asarray(x))
    _close(tl.conv2d(_t(p), torch.from_numpy(x), stride=2), want)
    shared = {k: v[0] for k, v in p.items()}
    want = jax.vmap(lambda xx: jl.conv2d(_j(shared), xx, stride=2))(
        jnp.asarray(x))
    _close(tl.conv2d(_t(shared), torch.from_numpy(x), stride=2), want)


def test_batch_norm_per_task_matches_jax_vmap():
    rng = _rng(2)
    x = (rng.normal(size=(3, 4, 5, 5, 6)) * np.arange(1, 4)[:, None, None,
                                                             None, None]
         ).astype(np.float32)
    p = {"scale": rng.uniform(0, 1, (3, 6)).astype(np.float32),
         "bias": rng.normal(size=(3, 6)).astype(np.float32)}
    want = jax.vmap(jl.batch_norm)(_j(p), jnp.asarray(x))
    got = tl.batch_norm(_t(p), torch.from_numpy(x))
    _close(got, want, 1e-5, 1e-5)
    # statistics never mix tasks: each task alone gives the same result
    for b in range(3):
        one = tl.batch_norm({k: v[b] for k, v in _t(p).items()},
                            torch.from_numpy(x[b]))
        _close(one, got[b], 1e-6, 1e-6)


def test_linear_max_pool_relu_mlp_match_jax():
    rng = _rng(3)
    x = rng.normal(size=(4, 7)).astype(np.float32)
    layers = [{"w": rng.normal(size=(7, 5)).astype(np.float32),
               "b": rng.normal(size=(5,)).astype(np.float32)},
              {"w": rng.normal(size=(5, 3)).astype(np.float32),
               "b": rng.normal(size=(3,)).astype(np.float32)}]
    _close(tl.linear(_t(layers[0]), torch.from_numpy(x)),
           jl.linear(_j(layers[0]), jnp.asarray(x)))
    _close(tl.mlp_apply(_t(layers), torch.from_numpy(x), torch.tanh),
           jl.mlp_apply(_j(layers), jnp.asarray(x), jnp.tanh))
    img = rng.normal(size=(2, 9, 9, 3)).astype(np.float32)
    _close(tl.max_pool2d(torch.from_numpy(img)),
           jl.max_pool2d(jnp.asarray(img)))
    _close(tl.relu(torch.from_numpy(img)), jl.relu(jnp.asarray(img)))


def test_per_task_linear_matches_jax_vmap():
    rng = _rng(4)
    x = rng.normal(size=(3, 4, 7)).astype(np.float32)
    p = {"w": rng.normal(size=(3, 7, 5)).astype(np.float32),
         "b": rng.normal(size=(3, 5)).astype(np.float32)}
    want = jax.vmap(jl.linear)(_j(p), jnp.asarray(x))
    _close(tl.linear(_t(p), torch.from_numpy(x)), want)
