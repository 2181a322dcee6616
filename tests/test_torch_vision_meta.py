"""MAML vision meta-training of the PyTorch port vs the JAX package, on
the CPU.

The second order through the fused CNN4 block (its CPU twins) against the
port's direct path and JAX, first and second order; two inner steps;
``make_meta_step``, ``adam``, ``cast_compute``, ``make_meta_eval`` and
``make_train_scan``. Identical params (bridged through numpy) and
identical task batches on both sides; the JAX side runs its plain
formulation (``set_conv_impl("direct")``, the math of ``_pure_base``),
vmapped over tasks, every variant in one jitted program.
``tests/test_torch_vision_anil.py`` holds ANIL and the Mini-ImageNet data.

Small: hidden 8, 5-way 1-shot, 2 tasks. Tolerances: meta-gradients at
``inner_lr`` 0.05 in f32, rtol 3e-4 / atol 3e-5 x max|grad| per leaf
(``tests/test_pallas_cnn4.py``); the conv-bias gradients are zero in
exact arithmetic (BN removes the bias) and are held by magnitude; bf16
losses within 2e-2 of f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from exploring_meta_tpu import adapt as jadapt
from exploring_meta_tpu.models import cnn4 as jc
from exploring_meta_tpu_torch.adapt import maml as tm
from exploring_meta_tpu_torch.adapt.vision import make_vision_fast_adapt
from exploring_meta_tpu_torch.cuda import cnn4_cuda as tc
from exploring_meta_tpu_torch.models import cnn4 as tcnn
from exploring_meta_tpu_torch.models.layers import get_conv_impl, set_conv_impl
from exploring_meta_tpu_torch.tasks import datasets as td
from exploring_meta_tpu_torch.tasks.sampler import sample_task_batch
from exploring_meta_tpu_torch.utils.bridge import params_to_numpy
from exploring_meta_tpu_torch.utils.tree import (
    tree_items, tree_leaves, tree_map, tree_unflatten,
)

WAYS, B, LR = 5, 2, 0.05
SPECS = {False: (jc.omniglot_spec(WAYS, hidden=8),
                 tcnn.omniglot_spec(WAYS, hidden=8)),
         True: (jc.anil_omniglot_spec(WAYS), tcnn.anil_omniglot_spec(WAYS))}


@pytest.fixture
def conv_impl():
    """Set the port's conv impl for one test; restore it after."""
    prev = get_conv_impl()
    yield set_conv_impl
    set_conv_impl(prev)


def _params(anil, seed=0):
    """numpy params of the spec, drawn by the port's init."""
    spec = SPECS[anil][1]
    return params_to_numpy(tcnn.init_cnn4(torch.Generator().manual_seed(seed),
                                          spec, device="cpu"))


def _torch_params(np_params):
    return tree_map(lambda a: torch.tensor(a, requires_grad=True), np_params)


def _task_batch(shots, seed=1, b=B):
    rng = np.random.default_rng(seed)
    data = rng.uniform(size=(b, WAYS * 2 * shots, 28, 28, 1)).astype(np.float32)
    labels = np.tile(np.repeat(np.arange(WAYS), 2 * shots), (b, 1))
    return data, labels.astype(np.int32)


def jax_refs(anil, shots, variants, np_params, data, labels):
    """JAX's mean query loss, mean metric and meta-grads over the task batch
    (the math of ``make_meta_step``'s ``batch_loss``) for each variant of
    ``make_vision_fast_adapt``'s options, in one jitted program: ``{name:
    (loss, metric, grads)}``."""
    jspec = SPECS[anil][0]

    def refs(p):
        out = {}
        for name, kw in variants.items():
            fa = jadapt.make_vision_fast_adapt(jspec, LR, shots=shots,
                                               ways=WAYS, anil=anil, **kw)

            def batch_loss(q):
                res = jax.vmap(lambda d, l: fa(q, d, l))(
                    jnp.asarray(data), jnp.asarray(labels))
                return jnp.mean(res.loss), jnp.mean(res.metric)

            (loss, metric), grads = jax.value_and_grad(
                batch_loss, has_aux=True)(p)
            out[name] = (loss, metric, grads)
        return out

    out = jax.jit(refs)(tree_map(jnp.asarray, np_params))
    return {k: (float(l), float(m), g) for k, (l, m, g) in out.items()}


MAML = {"second_order": dict(adapt_steps=1),
        "first_order": dict(adapt_steps=1, first_order=True),
        "two_steps": dict(adapt_steps=2)}


@pytest.fixture(scope="module")
def maml_ref():
    """The MAML variants on one 1-shot task batch: params, batch, JAX."""
    np_params, (data, labels) = _params(False), _task_batch(1)
    return np_params, data, labels, jax_refs(False, 1, MAML, np_params,
                                             data, labels)


def _port_loss_and_grads(fast_adapt, np_params, data, labels):
    params = _torch_params(np_params)
    res = fast_adapt(params, torch.from_numpy(data),
                     torch.from_numpy(labels).long())
    loss = res.loss.mean()
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return (float(loss.detach()), float(res.metric.mean()),
            tree_unflatten(params, grads))


def _held(got, want):
    """Leafwise |got - want| <= 3e-4 |want| + 3e-5 max|want|; conv-bias
    leaves by magnitude."""
    want = dict(tree_items(want))
    for key, g in tree_items(got):
        g, w = np.asarray(g.detach() if torch.is_tensor(g) else g), \
            np.asarray(want[key])
        if key.endswith("conv/b"):
            assert np.abs(g).max() < 1e-4 and np.abs(w).max() < 1e-4, key
            continue
        np.testing.assert_allclose(g, w, rtol=3e-4,
                                   atol=3e-5 * np.abs(w).max(), err_msg=key)


@pytest.mark.parametrize("variant", ["second_order", "first_order"])
def test_fused_second_order_meta_grad_matches_direct_and_jax(conv_impl,
                                                             maml_ref,
                                                             variant):
    np_params, data, labels, ref = maml_ref
    fa = make_vision_fast_adapt(SPECS[False][1], LR, shots=1, ways=WAYS,
                                **MAML[variant])
    got = {}
    for impl in ("fused", "direct"):
        conv_impl(impl)
        tc.reset_launch_counts()
        got[impl] = _port_loss_and_grads(fa, np_params, data, labels)
        # the CPU twins count no launch
        assert tc.launch_counts() == dict.fromkeys(tc.KERNELS, 0)
    want = ref[variant]
    for loss, metric, grads in got.values():
        np.testing.assert_allclose(loss, want[0], rtol=1e-5)
        assert metric == pytest.approx(want[1], abs=1e-6)
        _held(grads, want[2])
    _held(got["fused"][2], got["direct"][2])


def test_two_inner_steps_match_jax(conv_impl, maml_ref):
    conv_impl("fused")
    np_params, data, labels, ref = maml_ref
    got = _port_loss_and_grads(
        make_vision_fast_adapt(SPECS[False][1], LR, shots=1, ways=WAYS,
                               **MAML["two_steps"]),
        np_params, data, labels)
    want = ref["two_steps"]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert got[1] == pytest.approx(want[1], abs=1e-6)
    _held(got[2], want[2])


def test_meta_step_grads_and_metrics_match_jax(conv_impl, maml_ref):
    """The grads the step applied (left in ``.grad``) against JAX's
    ``make_meta_step`` math; the Adam update itself is checked on
    identical grads below, since after a real step a near-zero conv-bias
    gradient may flip the sign of Adam's first update."""
    conv_impl("fused")
    np_params, data, labels, ref = maml_ref
    params = _torch_params(np_params)
    step = tm.make_meta_step(make_vision_fast_adapt(SPECS[False][1], LR, 1,
                                                    1, WAYS))
    before = [p.detach().clone() for p in tree_leaves(params)]
    new, _, m = step(params, tm.adam(params, 3e-3), torch.from_numpy(data),
                     torch.from_numpy(labels).long())
    assert new is params
    assert not m["loss"].requires_grad
    want_loss, want_metric, want_grads = ref["second_order"]
    np.testing.assert_allclose(float(m["loss"]), want_loss, rtol=1e-5)
    assert float(m["metric"]) == pytest.approx(want_metric, abs=1e-6)
    _held(tree_unflatten(params, [p.grad for p in tree_leaves(params)]),
          want_grads)
    # Adam's first step moves a leaf by at most lr
    for p, p0 in zip(tree_leaves(params), before):
        assert float((p.detach() - p0).abs().max()) <= 3e-3 * (1 + 1e-5)


def test_adam_matches_optax_on_identical_grads():
    rng = np.random.default_rng(5)
    np_params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
                 "b": [rng.normal(size=(5,)).astype(np.float32)]}
    grads = [tree_map(lambda a: (rng.normal(size=a.shape) * 10.0 ** k)
                      .astype(np.float32), np_params) for k in (-3, 0, 2)]
    opt = optax.adam(1e-2)
    jp = tree_map(jnp.asarray, np_params)
    state = opt.init(jp)
    params = _torch_params(np_params)
    topt = tm.adam(params, 1e-2)
    for g in grads:
        updates, state = opt.update(tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, gg in zip(tree_leaves(params), tree_leaves(g)):
            p.grad = torch.from_numpy(gg)
        topt.step()
    for p, w in zip(tree_leaves(params), tree_leaves(jp)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="leaf"):
        tm.adam(tree_map(lambda t: t * 2, params), 1e-2)


def test_cast_compute_f32_results_bf16_within_2e2(conv_impl, maml_ref):
    conv_impl("fused")
    np_params, data, labels, ref = maml_ref
    params = _torch_params(np_params)
    res = tm.cast_compute(make_vision_fast_adapt(SPECS[False][1], LR, 1, 1,
                                                 WAYS))(
        params, torch.from_numpy(data), torch.from_numpy(labels).long())
    assert res.loss.dtype == res.metric.dtype == torch.float32
    grads = torch.autograd.grad(res.loss.mean(), tree_leaves(params))
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
               for g in grads)
    f32 = ref["second_order"][0]
    assert abs(float(res.loss.mean().detach()) - f32) <= 2e-2 * abs(f32)


def _tiny_split(seed):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, size=(8, 4, 28, 28, 1), dtype=np.uint8)
    return td.PackedDataset(images=torch.from_numpy(images), name="omni",
                            invert=True, rotations=True)


def test_train_scan_equals_meta_steps_with_pre_update_valid(conv_impl):
    conv_impl("fused")
    train_ds, valid_ds = _tiny_split(7), _tiny_split(8)
    fa = make_vision_fast_adapt(SPECS[False][1], 0.5, 1, 1, WAYS)

    def sample(ds):
        return lambda gen: sample_task_batch(gen, ds, WAYS, 1, B)

    runs = []
    for scan in (True, False):
        params = _torch_params(_params(False, seed=9))
        opt, gen = tm.adam(params, 3e-3), torch.Generator().manual_seed(10)
        if scan:
            params, opt, m = tm.make_train_scan(
                fa, sample(train_ds), 2, eval_sample_fn=sample(valid_ds))(
                    params, opt, gen)
        else:
            step, ev, rows = tm.make_meta_step(fa), tm.make_meta_eval(fa), []
            for _ in range(2):
                batch = sample(train_ds)(gen)
                v = ev(params, *sample(valid_ds)(gen))
                params, opt, out = step(params, opt, *batch)
                rows.append((out["loss"], out["metric"], v["loss"],
                             v["metric"]))
            m = dict(zip(("loss", "metric", "valid_loss", "valid_metric"),
                         (torch.stack(c) for c in zip(*rows))))
        runs.append((params, m))
    (p_scan, m_scan), (p_loop, m_loop) = runs
    assert set(m_scan) == {"loss", "metric", "valid_loss", "valid_metric"}
    for k in m_scan:
        assert m_scan[k].shape == (2,)
        torch.testing.assert_close(m_scan[k], m_loop[k], rtol=0, atol=0)
    for a, b in zip(tree_leaves(p_scan), tree_leaves(p_loop)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the first valid pass ran on the initial params
    gen = torch.Generator().manual_seed(10)
    sample(train_ds)(gen)
    v0 = tm.make_meta_eval(fa)(_torch_params(_params(False, seed=9)),
                               *sample(valid_ds)(gen))
    torch.testing.assert_close(m_scan["valid_loss"][0], v0["loss"])


def test_meta_eval_builds_no_graph_and_matches_second_order(conv_impl):
    conv_impl("fused")
    np_params, (data, labels) = _params(False), _task_batch(1, seed=11)
    fa = make_vision_fast_adapt(SPECS[False][1], LR, 2, 1, WAYS)
    params = _torch_params(np_params)
    args = (torch.from_numpy(data), torch.from_numpy(labels).long())
    ev = tm.make_meta_eval(fa)(params, *args)
    assert not ev["loss"].requires_grad
    res = fa(params, *args)
    torch.testing.assert_close(ev["loss"], res.loss.mean().detach())
    torch.testing.assert_close(ev["metric"], res.metric.mean())
