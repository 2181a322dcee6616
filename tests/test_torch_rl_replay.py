"""The PPO / VPG replay meta-loss and the Adam outer step of the PyTorch
port vs the JAX package (``rl/replay_meta.py``, ``optax.adam``), on the
CPU, on identical params and JAX-sampled trajectories replayed on both
sides. Sizes, data and tolerances are those of ``test_torch_rl_adam.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from exploring_meta_tpu.rl import replay_meta as jrm
from exploring_meta_tpu_torch.adapt.maml import (
    adam, apply_meta_gradient, per_task,
)
from exploring_meta_tpu_torch.rl import replay_meta as trm
from exploring_meta_tpu_torch.utils.bridge import params_from_jax
from exploring_meta_tpu_torch.utils.tree import tree_map
from test_torch_rl_adam import (  # noqa: F401  (data: a fixture)
    B, GRAD_REL, ROLLOUTS, _cfgs, _grads, _held, _items, _leaf_params,
    _loss_held, _loss_scale, _policies, _torch_traj, data,
)


_JAX = {}


def _jax_value_and_grad(data, algo, anil, steps):
    """JAX's replay meta-loss and meta-gradient, once per case (the Adam
    test reuses one)."""
    if (algo, anil, steps) not in _JAX:
        params, rep = data
        jpol, _ = _policies(anil)
        jcfg, _ = _cfgs(anil=anil, adapt_steps=steps)
        _JAX[algo, anil, steps] = jax.jit(jax.value_and_grad(
            jrm.make_replay_meta_loss(algo, jpol, jcfg)))(
                params[anil], _replays(rep, steps))
    return _JAX[algo, anil, steps]


def _replays(rep, steps):
    """The last ``steps`` supports and the query."""
    return jax.tree_util.tree_map(lambda x: x[:, ROLLOUTS - 1 - steps:], rep)


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("anil", [False, True])
@pytest.mark.parametrize("algo", ["ppo", "vpg"])
def test_replay_meta_loss_and_gradient_match_jax(data, algo, anil, steps):
    params, rep = data
    _, tpol = _policies(anil)
    _, tcfg = _cfgs(anil=anil, adapt_steps=steps)
    jl, jg = _jax_value_and_grad(data, algo, anil, steps)
    rep = _replays(rep, steps)
    tp = _leaf_params(params_from_jax(params[anil], "cpu"))
    trep = _torch_traj(rep)
    loss = trm.make_replay_meta_loss(algo, tpol, tcfg)(tp, trep)
    _loss_held(loss, jl, _loss_scale(algo, tpol, per_task(tp, B),
                                      trep.map(lambda x: x[:, -1]), tcfg))
    _held(_grads(tp, loss), jg, GRAD_REL)


def test_collect_replays_records_what_the_feeder_replays(data):
    params, rep = data
    _, tpol = _policies(False)
    _, tcfg = _cfgs(adapt_steps=2)
    trajs = [_torch_traj(jax.tree_util.tree_map(lambda x: x[:, i], rep))
             for i in range(ROLLOUTS)]
    it = iter(trajs)
    tp = params_from_jax(params[False], "cpu")
    stacked, metrics = trm.collect_replays(
        "ppo", tpol, tp, lambda p, t, g: next(it), torch.zeros(B), None, tcfg)
    for got, want in zip(stacked, _torch_traj(rep)):
        assert torch.equal(got, want)
    assert metrics["reward"].shape == (B,)
    feeder = trm.replay_feeder(stacked)
    for want in trajs:
        assert all(torch.equal(a, b)
                   for a, b in zip(feeder(None, None, None), want))
    with pytest.raises(ValueError, match="TRPO"):
        trm.make_replay_meta_loss("trpo", tpol, tcfg)


def test_adam_step_on_replays_matches_optax(data):
    params, rep = data
    rep = _replays(rep, 1)
    _, tpol = _policies(False)
    _, tcfg = _cfgs()
    lr, opt = 0.1, optax.adam(0.1)

    @jax.jit
    def step(p, grads):
        updates, _ = opt.update(grads, opt.init(p), p)
        return optax.apply_updates(p, updates)

    def optax_step(grads):
        return _items(step(params[False], grads))

    _, jgrad = _jax_value_and_grad(data, "ppo", False, 1)
    tp = _leaf_params(params_from_jax(params[False], "cpu"))
    apply_meta_gradient(adam(tp, lr), trm.make_replay_meta_loss(
        "ppo", tpol, tcfg)(tp, _torch_traj(rep)), tp)
    got = _items(tp)
    # optax takes the bias correction 1 - 0.999 in float32 (1.3e-5 off),
    # torch in double: the steps differ by ~6.4e-6 of lr
    atol = 1e-5 * lr
    # the step itself: optax on the port's own meta-gradient
    tgrad = tree_map(lambda t: jnp.asarray(t.grad.numpy()), tp)
    for key, w in optax_step(tgrad).items():
        np.testing.assert_allclose(got[key], w, rtol=0, atol=atol)
    # and the whole step against JAX's: the first Adam step is lr * g /
    # (|g| + eps), about lr * sign(g); it is held where |g| is resolved
    # far beyond the gradient's tolerance (1e-4 of the leaf's max|g|)
    want, g = optax_step(jgrad), _items(jgrad)
    for key, w in want.items():
        big = np.abs(g[key]) > 1e-2 * np.abs(g[key]).max()
        assert big.any()
        np.testing.assert_allclose(got[key][big], w[big], rtol=0, atol=atol)


@pytest.mark.parametrize("algo", ["ppo", "vpg"])
def test_adam_iterations_on_replays_match_jax_step_for_step(data, algo):
    """Three Adam iterations at the trainer's default outer_lr 0.1 on one
    set of replays. Each iteration starts both sides from the port's
    params: the port's meta-loss and meta-gradient there are held against
    JAX's (LOSS_REL, GRAD_REL), and the port's Adam step, its moments
    carried over the iterations, against optax's fed the same gradients.
    optax's float32 bias correction 1 - 0.999^t is off by 1.29e-5,
    1.95e-5 and 2.65e-5 of itself at t = 1, 2, 3 (torch's is double),
    which moves a step of up to ~lr by half that: held within 2e-5 of lr.
    A fault that builds up over iterations, in the meta-gradient away from
    the init or in the Adam state, shows here; the trajectories of two
    whole runs do not compare, since a first Adam step is ~lr x sign(g)
    and a near-zero g's sign may differ."""
    params, rep = data
    rep = _replays(rep, 1)
    jpol, tpol = _policies(False)
    jcfg, tcfg = _cfgs()
    lr, opt = 0.1, optax.adam(0.1)
    treedef = jax.tree_util.tree_structure(params[False])
    jvg = jax.jit(jax.value_and_grad(
        jrm.make_replay_meta_loss(algo, jpol, jcfg)))
    jupdate = jax.jit(lambda p, g, s: opt.update(g, s, p))
    meta_loss = trm.make_replay_meta_loss(algo, tpol, tcfg)
    trep = _torch_traj(rep)
    tp = _leaf_params(params_from_jax(params[False], "cpu"))
    topt, state = adam(tp, lr), opt.init(params[False])
    for _ in range(3):
        jp = jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(v) for v in _items(tp).values()])
        jl, jg = jvg(jp, rep)
        loss = meta_loss(tp, trep)
        _loss_held(loss, jl, _loss_scale(algo, tpol, per_task(tp, B),
                                          trep.map(lambda x: x[:, -1]), tcfg))
        apply_meta_gradient(topt, loss, tp)
        tgrad = tree_map(lambda t: t.grad, tp)
        _held(tgrad, jg, GRAD_REL)
        updates, state = jupdate(jp, jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(v, jnp.float32)
                      for v in _items(tgrad).values()]), state)
        want, got = _items(optax.apply_updates(jp, updates)), _items(tp)
        for key, w in want.items():
            np.testing.assert_allclose(got[key], w, rtol=0, atol=2e-5 * lr)
