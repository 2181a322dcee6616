"""The remaining policies of the PyTorch port vs the JAX package, on the
CPU: ``ops/stats.py``, the categorical distribution, ``DiagNormalPolicyCNN``,
``BaselineCNN`` and ``CategoricalPolicy``, and ``PolicyServer`` serving
each of them.

Both sides get the same numpy inputs and the JAX params carried across
(``utils/bridge.py:params_from_jax``). Small size: ``[4, 64, 64, 3]``
pixels through ``network=(8, 16)``, MLP hiddens (16, 16).

Tolerances. ``normalize``, ``onehot`` and the categorical log-prob are
held to 1e-6. The conv policies' float32 outputs to 1e-5 of max|out|
(measured 1.4e-6: the convs sum 3x3xC products in another order, and
batch-stat BN divides by the spread). In bfloat16 every conv output
rounds to bf16, and JAX's and PyTorch's CPU convs sum in different
orders, so the neighbouring-bf16 ties of ``tests/test_torch_rl_bf16.py``
are everywhere in a conv net: the bf16 density is held to four bf16 steps
(4 x 2^-8) of max|loc|, the bound that test allows a state at a tie
(measured 5.4e-3), and must lie closer to JAX's bf16 than to float32.
Sample frequencies of 20 000 categorical draws are held to 0.02 of
softmax (5 sigma at these probabilities). Served actions are held to
1e-6 and adapted params to 1e-5 of max|params|
(``tests/test_torch_policy_serve.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_meta_tpu.models import distributions as jdist
from exploring_meta_tpu.models.policies import BaselineCNN as JBase
from exploring_meta_tpu.models.policies import CategoricalPolicy as JCat
from exploring_meta_tpu.models.policies import DiagNormalPolicyCNN as JCNN
from exploring_meta_tpu.ops import stats as jstats
from exploring_meta_tpu.rl import adapt_rl as jrl
from exploring_meta_tpu.rl.rollout import Trajectory as JTraj
from exploring_meta_tpu.serve import PolicyServer as JServer
from exploring_meta_tpu_torch.models import distributions as tdist
from exploring_meta_tpu_torch.models.policies import (
    BaselineCNN, CategoricalPolicy, DiagNormalPolicyCNN,
)
from exploring_meta_tpu_torch.ops import stats as tstats
from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig
from exploring_meta_tpu_torch.serve import PolicyServer
from exploring_meta_tpu_torch.utils.bridge import params_from_jax
from exploring_meta_tpu_torch.utils.tree import tree_items

NET = (8, 16)
BF16_STEPS = 4 * 2.0 ** -8


def _perturbed(params, seed):
    """JAX init params moved off their init values (zero biases and a zero
    sigma would hide a wrong layer)."""
    return jax.tree_util.tree_map(
        lambda x: x + 0.05 * jax.random.normal(jax.random.key(seed),
                                               x.shape), params)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _pixels(n, seed=0):
    return np.random.default_rng(seed).uniform(
        0, 1, (n, 64, 64, 3)).astype(np.float32)


# -- ops/stats.py ---------------------------------------------------------

@pytest.mark.parametrize("shape", [(1,), (7,), (5, 3)])
def test_normalize_matches_jax(shape):
    x = np.random.default_rng(1).normal(2.0, 3.0, shape).astype(np.float32)
    got = tstats.normalize(torch.as_tensor(x)).numpy()
    want = np.asarray(jstats.normalize(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if x.size == 1:   # cherry's pass-through, not a zero
        assert np.array_equal(got, x)


def test_onehot_matches_jax():
    x = np.random.default_rng(2).integers(0, 6, (4, 3))
    got = tstats.onehot(torch.as_tensor(x), 6)
    assert got.dtype == torch.float32 and got.shape == (12, 6)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jstats.onehot(x, 6)))


# -- the categorical distribution -----------------------------------------

def test_categorical_log_prob_and_sample_frequencies():
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 1.5, (6, 4)).astype(np.float32)
    value = rng.integers(0, 4, (6,))
    got = tdist.categorical_log_prob(torch.as_tensor(logits),
                                     torch.as_tensor(value)).numpy()
    want = np.asarray(jdist.categorical_log_prob(jnp.asarray(logits),
                                                 jnp.asarray(value)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    row = torch.as_tensor(logits[:1]).expand(20000, 4)
    draws = tdist.categorical_sample(torch.Generator().manual_seed(0), row)
    assert draws.shape == (20000,) and draws.dtype == torch.int64
    freq = np.bincount(draws.numpy(), minlength=4) / 20000
    jdraws = np.asarray(jdist.categorical_sample(jax.random.key(0),
                                                 jnp.asarray(row.numpy())))
    jfreq = np.bincount(jdraws, minlength=4) / 20000
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits[0])))
    assert np.abs(freq - probs).max() < 0.02, (freq, probs)
    assert np.abs(jfreq - probs).max() < 0.02, (jfreq, probs)


# -- the conv policies ----------------------------------------------------

@pytest.fixture(scope="module")
def cnn():
    jpol = JCNN(3, 2, network=NET)
    jparams = _perturbed(jpol.init(jax.random.key(1)), 4)
    return jpol, jparams, params_from_jax(jparams, "cpu")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cnn_policy_density_and_log_prob_match_jax(cnn, dtype):
    jpol, jparams, params = cnn
    x = _pixels(4)
    a = np.random.default_rng(5).normal(0, 0.3, (4, 2)).astype(np.float32)
    jp = jpol._replace(compute_dtype=dtype)
    pol = DiagNormalPolicyCNN(3, 2, network=NET, compute_dtype=dtype)
    assert pol.flatten_size == jp.flatten_size == 16 * 16 * 16
    jloc, jscale = jp.density(jparams, jnp.asarray(x))
    loc, scale = pol.density(params, torch.as_tensor(x))
    lp = pol.log_prob(params, torch.as_tensor(x), torch.as_tensor(a))
    jlp = jp.log_prob(jparams, jnp.asarray(x), jnp.asarray(a))
    assert loc.dtype == lp.dtype == torch.float32 and lp.shape == (4, 1)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    if dtype == "f32":
        assert _rel(loc, jloc) <= 1e-5, _rel(loc, jloc)
        assert _rel(lp, jlp) <= 1e-5, _rel(lp, jlp)
    else:
        err = _rel(loc, jloc)
        assert err <= BF16_STEPS, err
        loc32, _ = DiagNormalPolicyCNN(3, 2, network=NET).density(
            params, torch.as_tensor(x))
        assert err < _rel(loc32, jloc), (err, _rel(loc32, jloc))


def test_cnn_policies_per_task_stack_match_jax(cnn):
    """A ``[B]`` stack of per-task params runs each task's convs (a grouped
    conv) and BN statistics on its own states, as ``jax.vmap``."""
    jpol, jparams, _ = cnn
    stack = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), jparams, _perturbed(jparams, 7))
    x = np.stack([_pixels(3, 1), _pixels(3, 2)])
    jloc, _ = jax.vmap(jpol.density)(stack, jnp.asarray(x))
    loc, _ = DiagNormalPolicyCNN(3, 2, network=NET).density(
        params_from_jax(stack, "cpu"), torch.as_tensor(x))
    assert loc.shape == (2, 3, 2) and _rel(loc, jloc) <= 1e-5

    jbase = JBase(3, network=NET)
    bstack = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *(_perturbed(jbase.init(
            jax.random.key(s)), s) for s in (2, 3)))
    jv = jax.vmap(jbase.apply)(bstack, jnp.asarray(x))
    v = BaselineCNN(3, network=NET).apply(params_from_jax(bstack, "cpu"),
                                           torch.as_tensor(x))
    assert v.shape == (2, 3, 1) and _rel(v, jv) <= 1e-5


def test_baseline_cnn_matches_jax():
    jbase = JBase(3, network=NET)
    jparams = _perturbed(jbase.init(jax.random.key(2)), 6)
    x = _pixels(4, 3)
    want = jbase.apply(jparams, jnp.asarray(x))
    got = BaselineCNN(3, network=NET).apply(params_from_jax(jparams, "cpu"),
                                            torch.as_tensor(x))
    assert got.shape == (4, 1) and _rel(got, want) <= 1e-5


def test_port_inits_have_jax_trees_and_distributions():
    gen = torch.Generator().manual_seed(0)
    for jspec, spec in ((JCNN(3, 2, network=NET),
                         DiagNormalPolicyCNN(3, 2, network=NET)),
                        (JBase(3, network=NET), BaselineCNN(3, network=NET)),
                        (JCat(5, 3, hiddens=(16, 16)),
                         CategoricalPolicy(5, 3, hiddens=(16, 16)))):
        want = {k: tuple(np.shape(v)) for k, v in
                tree_items(jspec.init(jax.random.key(0)))}
        params = spec.init(gen, device="cpu")
        assert {k: tuple(v.shape) for k, v in tree_items(params)} == want
        for key, leaf in tree_items(params):
            if key.endswith("/b") or key.endswith("bn/bias") or key == "sigma":
                assert not leaf.any(), key
            elif key.endswith("bn/scale"):
                assert 0 <= float(leaf.min()) and float(leaf.max()) <= 1


# -- the categorical policy -----------------------------------------------

@pytest.fixture(scope="module")
def cat():
    jpol = JCat(5, 3, hiddens=(16, 16))
    jparams = _perturbed(jpol.init(jax.random.key(3)), 8)
    return jpol, jparams, CategoricalPolicy(5, 3, hiddens=(16, 16))


def test_categorical_policy_logits_and_log_prob_match_jax(cat):
    jpol, jparams, pol = cat
    rng = np.random.default_rng(9)
    states, actions = rng.integers(0, 5, (7,)), rng.integers(0, 3, (7,))
    params = params_from_jax(jparams, "cpu")
    np.testing.assert_allclose(
        pol.logits(params, torch.as_tensor(states)).numpy(),
        np.asarray(jpol.logits(jparams, jnp.asarray(states))), atol=1e-6)
    np.testing.assert_allclose(
        pol.log_prob(params, torch.as_tensor(states),
                     torch.as_tensor(actions)).numpy(),
        np.asarray(jpol.log_prob(jparams, jnp.asarray(states),
                                 jnp.asarray(actions))), atol=1e-6)
    stack = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), jparams,
                                   _perturbed(jparams, 10))
    st = rng.integers(0, 5, (2, 7))
    np.testing.assert_allclose(
        pol.logits(params_from_jax(stack, "cpu"), torch.as_tensor(st)),
        np.asarray(jax.vmap(jpol.logits)(stack, jnp.asarray(st))),
        atol=1e-6)
    action, info = pol.sample(params, torch.Generator().manual_seed(1),
                              torch.as_tensor(states))
    assert action.shape == (7,) and not info["log_prob"].requires_grad
    np.testing.assert_allclose(
        info["log_prob"].numpy(),
        np.asarray(jpol.log_prob(jparams, jnp.asarray(states),
                                 jnp.asarray(action.numpy()))), atol=1e-6)


# -- PolicyServer on the three policies ------------------------------------

T, E = 6, 3
CFG = dict(inner_lr=0.1, adapt_steps=1, adapt_batch_size=E, max_path_length=T)


def _support(n, state, action, seed=11):
    """``n`` support trajectories ``[n, T, E, ...]`` as numpy."""
    rng = np.random.default_rng(seed)
    return JTraj(
        state=state, action=action,
        reward=rng.normal(size=(n, T, E)).astype(np.float32),
        done=np.zeros((n, T, E), np.float32),
        next_state=state, success=np.zeros((n, T, E), np.float32),
        valid=np.ones((n, T, E), np.float32),
        timestep=np.broadcast_to(np.arange(T, dtype=np.int32)[None, :, None],
                                 (n, T, E)).copy())


def _held(got, want, rel=1e-5):
    got = {k: np.asarray(v, np.float64) for k, v in tree_items(got)}
    want = {k: np.asarray(v, np.float64) for k, v in tree_items(want)}
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    for key, w in want.items():
        assert np.abs(got[key] - w).max() <= rel * top, key


@pytest.mark.parametrize("algo", ["vpg", "ppo", "trpo"])
def test_policy_server_categorical_matches_jax(cat, algo):
    """JAX's ``single_adapt_step`` runs for a categorical policy on integer
    states (its ``[T*E]`` log-probs broadcast against ``[T*E, 1]``
    advantages); the port's adapts the same params, acts on the argmax
    and samples ``(action, {"log_prob"})``."""
    jpol, jparams, pol = cat
    rng = np.random.default_rng(12)
    stack = _support(2, rng.integers(0, 5, (2, T, E, 1)),
                     rng.integers(0, 3, (2, T, E)))
    jserver = JServer(jpol, jparams, jrl.RLConfig(**CFG), algo=algo)
    server = PolicyServer(pol, params_from_jax(jparams, "cpu"),
                          RLConfig(**CFG), algo=algo, device="cpu")
    one = jax.tree_util.tree_map(lambda x: x[0], stack)
    _held(server.adapt(one), jserver.adapt(jax.tree_util.tree_map(
        jnp.asarray, one)))
    _held(server.adapt_batched(stack), jax.vmap(
        lambda p, s: jrl.single_adapt_step(algo, jpol, p, s,
                                           jrl.RLConfig(**CFG)))(
        jax.tree_util.tree_map(lambda x: jnp.stack([x, x]), jparams),
        jax.tree_util.tree_map(jnp.asarray, stack)))
    obs = rng.integers(0, 5, (2, E))
    adapted = server.adapt_batched(stack)
    jadapted = jax.tree_util.tree_map(jnp.asarray, jax.tree_util.tree_map(
        lambda t: t.numpy(), adapted))
    np.testing.assert_array_equal(
        server.act_batched(adapted, obs).numpy(),
        np.asarray(jserver.act_batched(jadapted, jnp.asarray(obs))))
    action, info = server.sample_batched(adapted,
                                         torch.Generator().manual_seed(0),
                                         obs)
    assert action.shape == (2, E)
    np.testing.assert_allclose(
        info["log_prob"].numpy(),
        np.asarray(jax.vmap(jpol.log_prob)(jadapted, jnp.asarray(obs),
                                           jnp.asarray(action.numpy()))),
        atol=1e-6)


def test_policy_server_cnn_acts_as_jax(cnn):
    """The conv policy's deterministic and stochastic actions (its
    ``adapt`` fits a linear baseline on 2 x 12 288 pixel features a task,
    a 2.4 GB system, so ``test_policy_server_cnn_adapt_matches_jax`` adapts
    a one-channel policy)."""
    jpol, jparams, params = cnn
    server = PolicyServer(DiagNormalPolicyCNN(3, 2, network=NET), params,
                          RLConfig(**CFG), device="cpu")
    jserver = JServer(jpol, jparams, jrl.RLConfig(**CFG))
    obs = _pixels(3, 4)
    assert _rel(server.act(params, obs), jserver.act(
        jparams, jnp.asarray(obs))) <= 1e-5
    stack = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), jparams,
                                   _perturbed(jparams, 9))
    tstack = params_from_jax(stack, "cpu")
    obs2 = np.stack([obs, _pixels(3, 5)])
    assert _rel(server.act_batched(tstack, obs2), jserver.act_batched(
        stack, jnp.asarray(obs2))) <= 1e-5
    a = server.sample_batched(tstack, torch.Generator().manual_seed(0), obs2)
    loc = server.act_batched(tstack, obs2)
    assert a.shape == (2, 3, 2) and not torch.equal(a, loc)


def test_policy_server_cnn_adapt_matches_jax():
    """One channel keeps the baseline's system at 8 196 features a task."""
    jpol = JCNN(1, 2, network=(4,))
    jparams = _perturbed(jpol.init(jax.random.key(5)), 3)
    rng = np.random.default_rng(13)
    pix = rng.uniform(0, 1, (1, T, E, 64, 64, 1)).astype(np.float32)
    one = jax.tree_util.tree_map(lambda x: x[0], _support(
        1, pix, rng.normal(0, 0.3, (1, T, E, 2)).astype(np.float32)))
    want = JServer(jpol, jparams, jrl.RLConfig(**CFG)).adapt(
        jax.tree_util.tree_map(jnp.asarray, one))
    got = PolicyServer(DiagNormalPolicyCNN(1, 2, network=(4,)),
                       params_from_jax(jparams, "cpu"), RLConfig(**CFG),
                       device="cpu").adapt(one)
    _held(got, want, rel=1e-4)
