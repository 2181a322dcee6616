"""PPO / VPG / ANIL meta-RL of the PyTorch port vs the JAX package, on the
CPU, on identical params and trajectories: the losses, the ANIL policy,
one inner step per algorithm, DiCE, and ANIL-TRPO's surrogate (the replay
meta-loss and the Adam step are in ``test_torch_rl_replay.py``).

Both sides get the same JAX-sampled trajectories, the port's as a support
batch or through its ``replay_feeder``. Params are bridged from JAX. Small size: B = 3 tasks, E = 4
episodes, T = 12 steps, hiddens (32, 32) (the ANIL head on 32 features).

Tolerances. The linear baseline is an ill-conditioned 8x8 float32 solve
(tests/test_torch_rl_trpo.py), so advantages agree to ~1e-5 relative and
the inner step ``inner_lr * g`` to ~1e-4 of itself. Adapted params are
held within 1e-5 of max|params| over the tree (the step is ~1e-2 of the
params; a zero-initialized bias holds only its step), meta-gradients within 1e-4 of max|grad| per leaf. A loss is a
mean of terms that cancel (PPO's at the query is 0 up to rounding: ratio
1 against zero-mean advantages), so it is held within 1e-5 of the mean
magnitude of its terms (:func:`_loss_scale`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_meta_tpu.envs.particles2d import Particles2D as JEnv
from exploring_meta_tpu.models.policies import DiagNormalPolicy as JPolicy
from exploring_meta_tpu.models.policies import DiagNormalPolicyANIL as JANIL
from exploring_meta_tpu.ops import losses as jlosses
from exploring_meta_tpu.rl import adapt_rl as jrl
from exploring_meta_tpu.rl import trpo_meta as jtm
from exploring_meta_tpu.rl.rollout import rollout as jrollout
from exploring_meta_tpu_torch.adapt.maml import per_task
from exploring_meta_tpu_torch.models.policies import (
    DiagNormalPolicy, DiagNormalPolicyANIL,
)
from exploring_meta_tpu_torch.ops import losses as tlosses
from exploring_meta_tpu_torch.rl import adapt_rl as trl
from exploring_meta_tpu_torch.rl import trpo_meta as ttm
from exploring_meta_tpu_torch.rl.rollout import Trajectory
from exploring_meta_tpu_torch.utils.bridge import params_from_jax
from exploring_meta_tpu_torch.utils.tree import (
    tree_items, tree_leaves, tree_map, tree_unflatten,
)

B, E, T = 3, 4, 12
HIDDENS = (32, 32)
ROLLOUTS = 3              # supports of two inner steps, then the query
CFG = dict(inner_lr=0.05, gamma=0.99, tau=1.0, adapt_batch_size=E,
           max_path_length=T)
PARAM_REL, LOSS_REL, GRAD_REL = 1e-5, 1e-5, 1e-4


def _policies(anil: bool):
    if anil:
        return (JANIL(2, 2, fc_neurons=HIDDENS[-1], hiddens=HIDDENS),
                DiagNormalPolicyANIL(2, 2, fc_neurons=HIDDENS[-1],
                                     hiddens=HIDDENS))
    return JPolicy(2, 2, hiddens=HIDDENS), DiagNormalPolicy(2, 2,
                                                            hiddens=HIDDENS)


def _cfgs(**kw):
    return jrl.RLConfig(**CFG, **kw), trl.RLConfig(**CFG, **kw)


@pytest.fixture(scope="module")
def data():
    """MAML and ANIL params (JAX), and per task ROLLOUTS trajectories of the
    MAML policy around its goal, stacked ``[B, ROLLOUTS, T, E, ...]``."""
    jpol, _ = _policies(False)
    params = {False: jpol.init(jax.random.key(0)),
              True: _policies(True)[0].init(jax.random.key(1))}
    goals = np.random.default_rng(0).uniform(-0.3, 0.3, size=(B, 2))
    roll = jax.jit(lambda g, k: jrollout(JEnv(), jpol.sample, params[False],
                                         g, k, E, T))
    keys = jax.random.split(jax.random.key(2), B * ROLLOUTS)
    trajs = [roll(jnp.asarray(goals[i // ROLLOUTS], jnp.float32), keys[i])
             for i in range(B * ROLLOUTS)]
    rep = jax.tree_util.tree_map(
        lambda *xs: np.stack(xs).reshape((B, ROLLOUTS) + xs[0].shape), *trajs)
    return params, rep


def _torch_traj(jtraj) -> Trajectory:
    return Trajectory(*(torch.as_tensor(np.array(x)) for x in jtraj))


def _items(tree) -> dict:
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v,
                          np.float64) for k, v in tree_items(tree)}


def _held(got, want, rel, what="", per_leaf=True):
    """``|got - want| <= rel * max|want|``, the max per leaf or, with
    ``per_leaf=False``, over the tree."""
    got, want = _items(got), _items(want)
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    for key, w in want.items():
        err = np.abs(got[key] - w).max()
        scale = np.abs(w).max() if per_leaf else top
        assert err <= rel * scale, (what, key, err, scale)


def _grads(params, loss):
    """d loss / d params as a tree in the params' structure (zero where
    the loss does not reach)."""
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return tree_unflatten(params, [torch.zeros_like(p) if g is None else g
                                   for p, g in zip(leaves, grads)])


def _loss_scale(algo, policy, params, traj, cfg) -> float:
    """The mean magnitude of a loss's terms on ``traj``: |log pi| x |A|
    for VPG's raw advantages; 1 for PPO's (a ratio near 1 times unit-
    variance normalized advantages)."""
    if algo == "ppo":
        return 1.0
    with torch.no_grad():
        lp = trl._log_prob(policy, params, traj)
        adv, _ = trl.traj_advantages(traj, cfg)
        terms = lp.abs() * traj.flat(adv).abs().unsqueeze(-1)
        return float(trl.masked_mean(terms, traj.flat(traj.valid)
                                     .unsqueeze(-1)).max())


def _loss_held(got, want, scale):
    assert abs(float(got) - float(want)) <= LOSS_REL * scale, (
        float(got), float(want), scale)


def _leaf_params(tparams):
    return tree_map(lambda t: t.clone().requires_grad_(), tparams)


# -- losses -------------------------------------------------------------------

def test_ppo_policy_loss_value_and_gradient_match_jax():
    rng = np.random.default_rng(1)
    old = rng.normal(size=(B, 40, 1)).astype(np.float32)
    # ratios across both clip bounds, and exact ties (ratio 1)
    new = old + rng.uniform(-0.6, 0.6, size=old.shape).astype(np.float32)
    new[:, :5] = old[:, :5]
    adv = rng.normal(size=old.shape).astype(np.float32)
    valid = (rng.uniform(size=old.shape) < 0.8).astype(np.float32)

    def jloss(n):
        return jax.vmap(lambda a, b, c, d: jlosses.ppo_policy_loss(
            a, b, c, clip=0.3, valid=d))(n, old, adv, valid)

    jl, jvjp = jax.vjp(jloss, jnp.asarray(new))
    cot = np.array([1.0, -2.0, 0.5], np.float32)
    (jg,) = jvjp(jnp.asarray(cot))
    n = torch.tensor(new, requires_grad=True)
    tl = tlosses.ppo_policy_loss(n, torch.tensor(old), torch.tensor(adv),
                                 clip=0.3, valid=torch.tensor(valid))
    (tg,) = torch.autograd.grad(tl, n, torch.tensor(cot))
    # a mean of O(1) terms, summed in another order: 1e-6 absolute
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)


def test_magic_box_and_weighted_cumsum_match_jax():
    rng = np.random.default_rng(2)
    v = rng.normal(size=(B, T, E)).astype(np.float32)
    w = rng.uniform(0.0, 1.0, size=(B, T, E)).astype(np.float32)
    cot = rng.normal(size=(B, T, E)).astype(np.float32)

    def jfn(v, w):
        return jax.vmap(lambda a, b: jlosses.magic_box(
            jlosses.weighted_cumsum(a, b)) * jlosses.weighted_cumsum(a, b))(
                v, w)

    jy, jvjp = jax.vjp(jfn, jnp.asarray(v), jnp.asarray(w))
    jgv, jgw = jvjp(jnp.asarray(cot))
    tv, tw = (torch.tensor(a, requires_grad=True) for a in (v, w))
    cs = tlosses.weighted_cumsum(tv, tw, dim=1)
    box = tlosses.magic_box(cs)
    assert torch.equal(box.detach(), torch.ones_like(box))
    ty = box * cs
    gv, gw = torch.autograd.grad(ty, (tv, tw), torch.tensor(cot))
    for got, want in ((ty.detach(), jy), (gv, jgv), (gw, jgw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


# -- the ANIL policy -------------------------------------------------------------

@pytest.mark.parametrize("anil", [False, True])
@pytest.mark.parametrize("layer", [-1, 1, 2, 3, 4])
def test_get_representation_matches_jax(data, anil, layer):
    params, _ = data
    jpol, tpol = _policies(anil)
    x = np.random.default_rng(3).normal(size=(7, 2)).astype(np.float32)
    want = jpol.get_representation(params[anil], jnp.asarray(x), layer)
    got = tpol.get_representation(params_from_jax(params[anil], "cpu"),
                                  torch.tensor(x), layer)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_anil_density_and_log_prob_match_jax(data):
    params, _ = data
    jpol, tpol = _policies(True)
    rng = np.random.default_rng(4)
    s = rng.normal(size=(9, 2)).astype(np.float32)
    a = rng.normal(size=(9, 2)).astype(np.float32)
    # the JAX tree crosses into the port's template (keys and shapes)
    template = tpol.init(torch.Generator().manual_seed(0))
    tp = _leaf_params(params_from_jax(params[True], "cpu", template=template))
    assert sorted(tp) == ["body", "head", "sigma"] and len(tp["body"]) == 2
    for stop in (False, True):
        jloc, jscale = jpol.density(params[True], s, stop_body_grad=stop)
        loc, scale = tpol.density(tp, torch.tensor(s), stop_body_grad=stop)
        np.testing.assert_allclose(loc.detach().numpy(), np.asarray(jloc),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(scale.detach().numpy(),
                                   np.asarray(jscale))
        jlp, jg = jax.jit(jax.value_and_grad(lambda p: jnp.sum(jpol.log_prob(
            p, s, a, stop_body_grad=stop))))(params[True])
        lp = tpol.log_prob(tp, torch.tensor(s), torch.tensor(a),
                           stop_body_grad=stop)
        assert lp.shape == (9, 1)
        assert float(lp.sum()) == pytest.approx(float(jlp), rel=1e-6)
        grads = _grads(tp, lp.sum())
        _held(grads, jg, 1e-5, f"stop_body_grad={stop}")
        body = np.abs(_items(grads["body"])["0/w"]).max()
        assert (body == 0) == stop


def test_anil_init_checks_the_head_width():
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="fc_neurons"):
        DiagNormalPolicyANIL(2, 2, fc_neurons=64).init(gen)
    p = DiagNormalPolicyANIL(2, 2, fc_neurons=64, hiddens=(100, 64)).init(gen)
    assert p["head"]["w"].shape == (64, 2)
    assert not p["sigma"].any() and not p["head"]["b"].any()


# -- one inner step on a collected support batch ------------------------------

@pytest.mark.parametrize("anil", [False, True])
@pytest.mark.parametrize("algo,epochs", [("vpg", 1), ("ppo", 1), ("ppo", 3),
                                         ("trpo", 1)])
def test_single_adapt_step_matches_jax(data, algo, epochs, anil):
    params, rep = data
    jpol, tpol = _policies(anil)
    jcfg, tcfg = _cfgs(anil=anil)
    support = jax.tree_util.tree_map(lambda x: x[:, 0], rep)
    want = jax.jit(jax.vmap(
        lambda s: jrl.single_adapt_step(algo, jpol, params[anil], s, jcfg,
                                        ppo_epochs=epochs)))(support)
    before = per_task(params_from_jax(params[anil], "cpu"), B)
    got = trl.single_adapt_step(algo, tpol, before, _torch_traj(support),
                                tcfg, ppo_epochs=epochs)
    _held(got, want, PARAM_REL, f"{algo} x{epochs}", per_leaf=False)
    moved = {k: np.abs(v - _items(before)[k]).max()
             for k, v in _items(got).items()}
    for key, d in moved.items():
        if anil and key.startswith("body"):
            assert d == 0, key             # the body is bit-for-bit kept
        else:
            assert d > 0, key


def test_policy_anil_mask():
    _, tpol = _policies(True)
    p = tpol.init(torch.Generator().manual_seed(0))
    mask = dict(tree_items(trl.policy_anil_mask(p)))
    assert mask == {"body/0/b": False, "body/0/w": False, "body/1/b": False,
                    "body/1/w": False, "head/b": True, "head/w": True,
                    "sigma": True}


@pytest.mark.parametrize("dice", [False, True])
def test_vpg_a2c_loss_and_gradient_match_jax(data, dice):
    params, rep = data
    jpol, tpol = _policies(False)
    jcfg, tcfg = _cfgs()
    traj = jax.tree_util.tree_map(lambda x: x[:, 1], rep)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jnp.sum(jax.vmap(
        lambda t: jrl.vpg_a2c_loss(jpol, p, t, jcfg, dice=dice))(traj))))(
            params[False])
    tp = _leaf_params(params_from_jax(params[False], "cpu"))
    ttraj = _torch_traj(traj)
    loss = trl.vpg_a2c_loss(tpol, per_task(tp, B), ttraj, tcfg, dice=dice)
    assert loss.shape == (B,)
    # DiCE's magic box is 1 in value: the loss is the plain one
    _loss_held(loss.sum(), jl,
               B * _loss_scale("vpg", tpol, tp, ttraj, tcfg))
    _held(_grads(tp, loss.sum()), jg, GRAD_REL)


# -- ANIL-TRPO: the surrogate's second-order re-adaptation ----------------------

def test_anil_trpo_surrogate_and_gradient_match_jax(data):
    params, rep = data
    rep = jax.tree_util.tree_map(lambda x: x[:, 1:], rep)
    jpol, tpol = _policies(True)
    jcfg, tcfg = _cfgs(anil=True)
    near = jax.tree_util.tree_map(
        lambda x: x + 0.01 * jax.random.normal(jax.random.key(3), x.shape),
        params[True])
    jold = jax.tree_util.tree_map(
        lambda x: np.broadcast_to(np.asarray(x), (B,) + x.shape), near)
    (jl, jkl), jg = jax.jit(jax.value_and_grad(
        lambda p: jtm.meta_surrogate_loss(jpol, p, jold, rep, jcfg, 1),
        has_aux=True))(params[True])
    tp = _leaf_params(params_from_jax(params[True], "cpu"))
    loss, kl = ttm.meta_surrogate_loss(tpol, tp, params_from_jax(jold, "cpu"),
                                       _torch_traj(rep), tcfg, 1)
    assert abs(float(loss)) > 1e-4 and float(kl) > 1e-5
    assert float(loss) == pytest.approx(float(jl), rel=LOSS_REL)
    assert float(kl) == pytest.approx(float(jkl), rel=1e-4)
    grads = _grads(tp, loss)
    _held(grads, jg, GRAD_REL)
    # the query loss reaches the body through the full graph
    assert float(grads["body"][0]["w"].abs().max()) > 0
