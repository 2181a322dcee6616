"""MAML-TRPO collection and outer step of the PyTorch port vs the JAX
package, on the CPU, on identical params and trajectories.

JAX vmaps over tasks; the port writes the task axis out. Both sides get
the same fixed JAX trajectories (support, then query) through a rollout
function that replays them, and the same params (bridged from JAX).
Small size: B = 3 tasks, E = 4 episodes, T = 12 steps, hiddens (32, 32).

Tolerances. The linear baseline is an ill-conditioned 8x8 float32 solve,
so its fitted values, and the normalized advantages after it, agree to
~1e-5 relative, not to the last bit; everything downstream is held
relative to that. The outer step's CG amplifies such differences (see
``test_meta_optimize_trpo_matches_jax_step``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_meta_tpu.envs.particles2d import Particles2D as JEnv
from exploring_meta_tpu.models.policies import DiagNormalPolicy as JPolicy
from exploring_meta_tpu.rl import adapt_rl as jrl
from exploring_meta_tpu.rl import trpo_meta as jtm
from exploring_meta_tpu.rl.rollout import rollout as jrollout
from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
from exploring_meta_tpu_torch.rl import adapt_rl as trl
from exploring_meta_tpu_torch.rl import trpo_meta as ttm
from exploring_meta_tpu_torch.rl.rollout import Trajectory
from exploring_meta_tpu_torch.utils.bridge import params_from_jax
from exploring_meta_tpu_torch.utils.tree import (
    tree_items, tree_leaves, tree_map, tree_unflatten,
)

B, E, T = 3, 4, 12
HIDDENS = (32, 32)
JCFG = jrl.RLConfig(inner_lr=0.05, gamma=0.99, tau=1.0, adapt_steps=1,
                    adapt_batch_size=E, max_path_length=T)
TCFG = trl.RLConfig(inner_lr=0.05, gamma=0.99, tau=1.0, adapt_steps=1,
                    adapt_batch_size=E, max_path_length=T)
# the Gaussian KL at ~1e-4 is a difference of O(1) float32 terms
# (var_ratio - 1 - log var_ratio), so its rounding is ~1e-5 relative
KL_REL = 1e-4
TRPO = dict(outer_lr=0.1, max_kl=0.01, ls_max_steps=15,
            backtrack_factor=0.5, cg_iterations=10, damping=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    """Torch or JAX params -> flat float64 numpy, in the JAX leaf order."""
    if isinstance(tree, dict) and isinstance(tree.get("sigma"), torch.Tensor):
        tree = tree_map(lambda t: t.detach().numpy(), tree)
    return np.concatenate([np.asarray(x, np.float64).ravel()
                           for x in jax.tree_util.tree_leaves(tree)])


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def setup():
    """JAX policy params, and per task a support and a query trajectory
    collected by that policy around the goal."""
    jpol = JPolicy(2, 2, hiddens=HIDDENS)
    jparams = jpol.init(jax.random.key(0))
    goals = jnp.asarray(np.random.default_rng(0).uniform(
        -0.3, 0.3, size=(B, 2)), jnp.float32)
    roll = lambda p, g, k: jrollout(JEnv(), jpol.sample, p, g, k, E, T)
    keys = jax.random.split(jax.random.key(1), 2 * B).reshape(2, B)
    support = jax.vmap(roll, (None, 0, 0))(jparams, goals, keys[0])
    query = jax.vmap(roll, (None, 0, 0))(jparams, goals, keys[1])
    return jpol, jparams, _np(support), _np(query)


def _torch_traj(jtraj) -> Trajectory:
    return Trajectory(*(torch.as_tensor(np.array(x)) for x in jtraj))


def _replayer(trajs):
    """A rollout function that returns ``trajs`` in turn, ignoring the
    params, the task and the randomness."""
    it = iter(trajs)
    return lambda params, task, key: next(it)


def _jax_collect(jpol, jparams, support, query):
    """JAX ``trpo_collect_body`` under vmap; the task is an index into the
    fixed trajectories."""
    def roll_for(trajs):
        def roll(params, task, key):
            return jax.tree_util.tree_map(
                lambda x: jnp.asarray(x)[task.astype(jnp.int32)], trajs)
        return roll
    calls = iter([roll_for(support), roll_for(query)])
    collect = jax.jit(jrl.trpo_collect_body(
        jpol, lambda p, t, k: next(calls)(p, t, k), JCFG))
    return collect(jparams, jnp.arange(B, dtype=jnp.float32),
                   jax.random.split(jax.random.key(2), B))


def test_fast_adapt_trpo_matches_jax(setup):
    jpol, jparams, support, query = setup
    pol = DiagNormalPolicy(2, 2, hiddens=HIDDENS)
    params = params_from_jax(jparams, "cpu")
    adapted, loss, replay, m = trl.fast_adapt_trpo(
        pol, params, _replayer([_torch_traj(support), _torch_traj(query)]),
        torch.zeros(B, 2), None, TCFG)
    assert [r.reward.shape for r in replay] == [(B, T, E)] * 2
    assert not any(t.requires_grad for t in tree_leaves(adapted))
    for b in range(B):
        pick = lambda tr: jax.tree_util.tree_map(lambda x: x[b], tr)
        ja, jloss, _, jm = jax.jit(lambda p, k: jrl.fast_adapt_trpo(
            jpol, p, _replayer([pick(support), pick(query)]), None, k,
            JCFG))(jparams, jax.random.key(b))
        got = tree_map(lambda t: t[b], adapted)
        # the inner step moves the params by ~1e-2; hold the move
        step = _leaves(ja) - _leaves(jparams)
        assert np.abs(_leaves(got) - _leaves(ja)).max() <= (
            1e-4 * np.abs(step).max())
        assert float(loss[b]) == pytest.approx(float(jloss), rel=1e-4)
        assert float(m["reward"][b]) == pytest.approx(float(jm["reward"]),
                                                      rel=1e-6)
        assert float(m["success"][b]) == float(jm["success"])


def test_trpo_collect_body_matches_jax_vmap(setup):
    jpol, jparams, support, query = setup
    ja, jloss, jrep, jm = _jax_collect(jpol, jparams, support, query)
    pol = DiagNormalPolicy(2, 2, hiddens=HIDDENS)
    collect = trl.trpo_collect_body(
        pol, _replayer([_torch_traj(support), _torch_traj(query)]), TCFG)
    adapted, loss, rep, m = collect(params_from_jax(jparams, "cpu"),
                                    torch.arange(B).float(), None)
    assert rep.reward.shape == (B, 2, T, E)
    for name in Trajectory._fields:
        np.testing.assert_array_equal(getattr(rep, name).numpy(),
                                      np.asarray(getattr(jrep, name)))
    step = _leaves(ja) - _leaves(jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), jparams))
    assert np.abs(_leaves(adapted) - _leaves(ja)).max() <= (
        1e-4 * np.abs(step).max())
    assert _rel(loss.numpy(), jloss) <= 1e-4
    np.testing.assert_allclose(m["reward"].numpy(), np.asarray(jm["reward"]),
                               rtol=1e-6)


@pytest.fixture(scope="module")
def outer(setup):
    """Meta params, the collection-time adapted params of a nearby policy
    (so that the surrogate and the KL are not 0 at the meta params), and
    the stacked replays; on both sides."""
    jpol, jparams, support, query = setup
    near = jax.tree_util.tree_map(
        lambda x: x + 0.01 * jax.random.normal(jax.random.key(3), x.shape),
        jparams)
    jold, _, jrep, _ = _jax_collect(jpol, near, support, query)
    return (jpol, jparams, _np(jold), _np(jrep),
            params_from_jax(jparams, "cpu"), params_from_jax(jold, "cpu"),
            _torch_traj(jrep))


def test_meta_surrogate_loss_kl_and_gradient_match_jax(outer):
    jpol, jparams, jold, jrep, params, old, rep = outer
    pol = DiagNormalPolicy(2, 2, hiddens=HIDDENS)

    def jloss(p):
        return jtm.meta_surrogate_loss(jpol, p, jold, jrep, JCFG, 1)

    (jl, jkl), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams)
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    loss, kl = ttm.meta_surrogate_loss(pol, params, old, rep, TCFG, 1)
    grads = torch.autograd.grad(loss, leaves)
    assert float(kl) > 1e-5 and abs(float(loss)) > 1e-4
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    assert float(kl) == pytest.approx(float(jkl), rel=KL_REL)
    # torch leaf order (insertion) vs JAX (sorted keys): compare by tree
    tgrad = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jparams),
        [g.numpy() for g in _torch_order_to_jax(params, grads)])
    assert _rel(_leaves(tgrad), _leaves(jgrad)) <= 1e-4


def _torch_order_to_jax(params, grads):
    """Grads listed in the port's leaf order -> the JAX leaf order."""
    tree = tree_unflatten(params, list(grads))
    return [leaf for _, leaf in tree_items(tree)]


def test_meta_optimize_trpo_matches_jax_step(outer):
    jpol, jparams, jold, jrep, params, old, rep = outer
    pol = DiagNormalPolicy(2, 2, hiddens=HIDDENS)
    jstep = jtm.make_trpo_meta_step(jpol, JCFG, jtm.TRPOConfig(**TRPO), 1)
    jnew, jinfo = jstep(jparams, jold, jrep)
    new, info = ttm.meta_optimize_trpo(pol, params, old, rep, TCFG,
                                       ttm.TRPOConfig(**TRPO), 1)
    assert info["accepted"] == bool(jinfo["accepted"]) is True
    assert float(info["old_loss"]) == pytest.approx(float(jinfo["old_loss"]),
                                                    rel=1e-5)
    step = _leaves(jnew) - _leaves(jparams)
    assert np.linalg.norm(step) > 1e-3
    # CG in float32 on a Fisher damped by 1e-5 amplifies last-bit
    # differences: with Fisher-vector products equal to 1e-7 the CG
    # directions differ by 3e-4 and s^T F s by 4 %. JAX's jitted step and
    # the same step run eagerly differ by 8e-3 of the step on these
    # inputs; the port is held to 2e-2 (measured: 6e-3).
    err = np.linalg.norm(_leaves(new) - _leaves(jnew))
    assert err <= 2e-2 * np.linalg.norm(step), err / np.linalg.norm(step)
    # the step improved the surrogate inside the trust region, as in JAX
    loss, kl = ttm.meta_surrogate_loss(pol, new, old, rep, TCFG, 1)
    assert float(loss) < float(info["old_loss"]) and float(kl) < 0.01
    # and at one point, JAX's new params, both surrogates agree
    jl, jkl = jtm.meta_surrogate_loss(jpol, jnew, jold, jrep, JCFG, 1)
    loss, kl = ttm.meta_surrogate_loss(pol, params_from_jax(jnew, "cpu"),
                                       old, rep, TCFG, 1)
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    assert float(kl) == pytest.approx(float(jkl), rel=KL_REL)


def test_stack_replays_and_make_trpo_meta_step(outer):
    _, _, _, _, params, old, rep = outer
    one = rep.map(lambda x: x[:, 0])
    stacked = ttm.stack_replays([one, rep.map(lambda x: x[:, 1])])
    for a, b in zip(stacked, rep):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    pol = DiagNormalPolicy(2, 2, hiddens=HIDDENS)
    step = ttm.make_trpo_meta_step(pol, TCFG, ttm.TRPOConfig(**TRPO), 1)
    new, info = step(params, old, stacked)
    direct, _ = ttm.meta_optimize_trpo(pol, params, old, rep, TCFG,
                                       ttm.TRPOConfig(**TRPO), 1)
    for a, b in zip(tree_leaves(new), tree_leaves(direct)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert not a.requires_grad
