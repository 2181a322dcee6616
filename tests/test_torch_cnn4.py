"""CNN4 of the PyTorch port vs ``exploring_meta_tpu.models.cnn4``.

JAX params are bridged into the port (a keyed copy: both keep HWIO conv
and ``[in, out]`` linear weights) and both forwards see the same numpy
images. Init distributions are checked against their stated ranges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_meta_tpu.models import cnn4 as jc
from exploring_meta_tpu_torch.models import cnn4 as tcnn
from exploring_meta_tpu_torch.models import init as tinit
from exploring_meta_tpu_torch.models.layers import get_conv_impl, set_conv_impl
from exploring_meta_tpu_torch.utils.bridge import params_from_jax, params_to_numpy

SPECS = {
    "omniglot": (jc.omniglot_spec(ways=5, hidden=8),
                 tcnn.omniglot_spec(ways=5, hidden=8)),
    "mini_imagenet": (jc.mini_imagenet_spec(ways=5, hidden=8),
                      tcnn.mini_imagenet_spec(ways=5, hidden=8)),
    "anil_omniglot": (jc.anil_omniglot_spec(ways=5),
                      tcnn.anil_omniglot_spec(ways=5)),
}


def _images(spec, n, seed, lead=()):
    rng = np.random.default_rng(seed)
    return rng.normal(size=lead + (n, spec.image_size, spec.image_size,
                                   spec.channels)).astype(np.float32)


@pytest.fixture(params=["direct", "fused"])
def conv_impl(request):
    prev = get_conv_impl()
    set_conv_impl(request.param)
    try:
        yield request.param
    finally:
        set_conv_impl(prev)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_cnn4_apply_matches_jax(name, conv_impl):
    jspec, tspec = SPECS[name]
    assert tuple(jspec) == tuple(tspec)
    jparams = jc.init_cnn4(jax.random.key(0), jspec)
    tparams = params_from_jax(jparams, "cpu",
                              template=tcnn.init_cnn4(
                                  torch.Generator().manual_seed(0), tspec,
                                  device="cpu"))
    x = _images(jspec, 3, 1)
    want = jc.cnn4_apply(jparams, jspec, jnp.asarray(x))
    got = tcnn.cnn4_apply(tparams, tspec, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    assert tcnn.count_params(tparams) == jc.count_params(jparams)
    rep = tcnn.get_rep_layer(tparams, tspec, torch.from_numpy(x), 2)
    np.testing.assert_allclose(
        rep.numpy(), np.asarray(jc.get_rep_layer(jparams, jspec,
                                                 jnp.asarray(x), 2)),
        rtol=1e-4, atol=1e-4)


def test_task_batched_forward_matches_jax_vmap(conv_impl):
    jspec, tspec = SPECS["omniglot"]
    jparams = jc.init_cnn4(jax.random.key(1), jspec)
    tparams = params_from_jax(jparams, "cpu")
    x = _images(jspec, 3, 2, lead=(2,))
    want = jax.vmap(lambda xx: jc.cnn4_apply(jparams, jspec, xx))(
        jnp.asarray(x))
    got = tcnn.cnn4_apply(tparams, tspec, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_routing_rule():
    prev = get_conv_impl()
    try:
        set_conv_impl("fused")
        assert tcnn.uses_fused_base(tcnn.omniglot_spec())
        assert not tcnn.uses_fused_base(tcnn.mini_imagenet_spec())
        assert not tcnn.uses_fused_base(tcnn.anil_omniglot_spec())
        assert not tcnn.uses_fused_base(tcnn.omniglot_spec(layers=3))
        set_conv_impl("direct")
        assert not tcnn.uses_fused_base(tcnn.omniglot_spec())
    finally:
        set_conv_impl(prev)


def test_bridge_round_trip_and_module():
    jspec, tspec = SPECS["omniglot"]
    jparams = jc.init_cnn4(jax.random.key(2), jspec)
    tparams = params_from_jax(jparams, "cpu")
    back = params_to_numpy(tparams)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))
    model = tcnn.CNN4(tspec, tparams)
    x = torch.from_numpy(_images(tspec, 2, 3))
    torch.testing.assert_close(model(x),
                               tcnn.cnn4_apply(tparams, tspec, x))
    assert sum(p.numel() for p in model.parameters()) == \
        tcnn.count_params(tparams)
    with pytest.raises(ValueError):
        params_from_jax(jparams, "cpu", template=tcnn.init_cnn4(
            torch.Generator().manual_seed(0), tcnn.omniglot_spec(hidden=4),
            device="cpu"))


def test_init_distributions():
    g = torch.Generator().manual_seed(0)
    spec = tcnn.omniglot_spec(ways=5)
    p = tcnn.init_cnn4(g, spec, device="cpu")
    for i, blk in enumerate(p["base"]):
        ci = 1 if i == 0 else 64
        a = np.sqrt(6.0 / (ci * 9 + 64 * 9))
        w = blk["conv"]["w"]
        assert w.shape == (3, 3, ci, 64)
        assert w.abs().max() <= a and w.abs().max() > 0.9 * a
        assert torch.all(blk["conv"]["b"] == 0)
        s = blk["bn"]["scale"]
        assert torch.all((s >= 0) & (s < 1))
        assert torch.all(blk["bn"]["bias"] == 0)
    hw = p["head"]["w"]
    assert hw.shape == (64, 5) and abs(float(hw.std()) - 1.0) < 0.2
    t = tinit.truncated_normal(g, (20000,), std=0.01)
    assert float(t.abs().max()) <= 0.02 + 1e-7
    assert abs(float(t.std()) - 0.01 * 0.8796) < 5e-4
    d = tinit.linear_params(g, 128, 5, init="torch_default")
    bound = np.sqrt(1.0 / 128)
    assert float(d["w"].abs().max()) <= bound
    assert float(d["b"].abs().max()) <= bound
    x = tinit.linear_params(g, 800, 5, init="xavier")["w"]
    assert float(x.abs().max()) <= np.sqrt(6.0 / 805)
    with pytest.raises(ValueError):
        tinit.linear_params(g, 2, 2, init="bogus")
