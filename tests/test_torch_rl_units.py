"""RL building blocks of the PyTorch port vs the JAX package, on the CPU.

Env, rollout, policy, value baseline, advantages, masked normalization,
conjugate gradient and Hessian-vector products, each fed the same numpy
inputs (or the same JAX trajectory) on both sides. Small size: B = 3
tasks, E = 4 episodes, T = 12 steps, hiddens (32, 32).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_meta_tpu.envs.particles2d import Particles2D as JEnv
from exploring_meta_tpu.models import distributions as jdist
from exploring_meta_tpu.models.policies import DiagNormalPolicy as JPolicy
from exploring_meta_tpu.ops import cg as jcg
from exploring_meta_tpu.ops import value as jvalue
from exploring_meta_tpu.rl import adapt_rl as jrl
from exploring_meta_tpu.rl.rollout import rollout as jrollout
from exploring_meta_tpu_torch.envs.particles2d import Particles2D
from exploring_meta_tpu_torch.models import distributions as tdist
from exploring_meta_tpu_torch.models.policies import (
    MIN_LOG_SIGMA, DiagNormalPolicy,
)
from exploring_meta_tpu_torch.ops import cg as tcg
from exploring_meta_tpu_torch.ops import value as tvalue
from exploring_meta_tpu_torch.rl import adapt_rl as trl
from exploring_meta_tpu_torch.rl.rollout import Trajectory, rollout
from exploring_meta_tpu_torch.utils.bridge import params_from_jax

B, E, T = 3, 4, 12
HIDDENS = (32, 32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, rel=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


# -- env ----------------------------------------------------------------------

def test_env_step_matches_jax_exactly():
    jenv, env = JEnv(), Particles2D()
    rng = np.random.default_rng(0)
    goals = np.array([[0.05, -0.03], [0.3, 0.2], [-0.2, 0.4]], np.float32)
    jstep = jax.vmap(jax.vmap(jenv.step, (0, 0, None)), (0, 0, 0))
    jstate = jax.vmap(jax.vmap(lambda g: jenv.reset(None, g)[0]),
                      in_axes=0)(np.repeat(goals[:, None], E, 1))
    state, _ = env.reset(_t(goals), E)
    for step in range(6):
        actions = rng.normal(scale=0.08, size=(B, E, 2)).astype(np.float32)
        if step == 0:
            actions[0, 0] = goals[0]                      # exact hit
            actions[0, 1] = goals[0] + [0.009, -0.009]    # in the box only
            actions[0, 2] = goals[0] + [0.011, 0.0]       # just outside
            actions[1, 0] = [0.5, -0.5]                   # clipped to 0.1
        jstate, jobs, jrew, jdone, jsuc = jstep(jstate, actions, goals)
        state, obs, rew, done, suc = env.step(state, _t(actions), _t(goals))
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
        np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(suc.numpy(), np.asarray(jsuc))
        np.testing.assert_array_equal(state.t.numpy(), np.asarray(jstate.t))
        if step == 0:
            # box, not disk: |dx|, |dy| < 0.01 at a distance of 0.0127
            assert done[0, :3].tolist() == [True, True, False]
            frozen = obs[0, :2].clone()
            np.testing.assert_allclose(obs[1, 0].numpy(), [0.1, -0.1])
    np.testing.assert_array_equal(state.pos[0, :2].numpy(), frozen.numpy())


def test_sample_tasks_range():
    goals = Particles2D().sample_tasks(torch.Generator().manual_seed(0), 500)
    assert goals.shape == (500, 2)
    assert float(goals.min()) >= -0.5 and float(goals.max()) < 0.5
    assert abs(float(goals.mean())) < 0.05


# -- rollout ------------------------------------------------------------------

def _jax_trajectories(seed=0, goals=None):
    """[B] JAX rollouts: half the episodes head straight for the goal
    (so they terminate and leave filler steps), half wander."""
    jenv = JEnv()
    if goals is None:
        goals = np.random.default_rng(seed).uniform(
            -0.25, 0.25, size=(B, 2)).astype(np.float32)
    steer = jnp.asarray(np.arange(E) % 2 == 0)[:, None]

    def one(goal, key):
        def sample(params, k, obs):
            noise = 0.07 * jax.random.normal(k, obs.shape)
            return jnp.where(steer, goal - obs + 0.003 * noise, noise)
        return jrollout(jenv, sample, None, goal, key, E, T)

    keys = jax.random.split(jax.random.key(seed), B)
    return jax.vmap(one)(jnp.asarray(goals), keys), goals


def _to_torch(jtraj) -> Trajectory:
    return Trajectory(*(_t(x) for x in jtraj))


def test_rollout_replaying_jax_actions_reproduces_the_trajectory():
    jtraj, goals = _jax_trajectories(1)
    assert float(jnp.sum(1 - jtraj.valid)) > 0   # some episodes terminated
    actions = np.asarray(jtraj.action)
    step = iter(range(T))

    def replay(params, gen, obs):
        return _t(actions[:, next(step)])

    traj = rollout(Particles2D(), replay, None, _t(goals),
                   torch.Generator(), E, T)
    for name in Trajectory._fields:
        got, want = getattr(traj, name).numpy(), np.asarray(
            getattr(jtraj, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(traj.episode_rewards().numpy(),
                                  np.asarray(jax.vmap(
                                      lambda t: t.episode_rewards())(jtraj)))
    np.testing.assert_array_equal(traj.episode_successes().numpy(),
                                  np.asarray(jax.vmap(
                                      lambda t: t.episode_successes())(jtraj)))


def test_rollout_with_the_policy_keeps_no_graph():
    policy = DiagNormalPolicy(2, 2, hiddens=HIDDENS)
    gen = torch.Generator().manual_seed(0)
    params = policy.init(gen, device="cpu")
    params = {"mean": [{k: v.requires_grad_() for k, v in layer.items()}
                       for layer in params["mean"]],
              "sigma": params["sigma"].requires_grad_()}
    tasks = Particles2D().sample_tasks(gen, B)
    traj = rollout(Particles2D(), policy.sample, params, tasks, gen, E, T)
    assert traj.state.shape == (B, T, E, 2) and traj.timestep.shape == (B, T, E)
    assert not any(x.requires_grad for x in traj)
    # the last valid step is done
    assert bool((traj.done[:, -1] >= traj.valid[:, -1]).all())


# -- policy and distributions ------------------------------------------------

def test_policy_density_and_log_prob_match_jax():
    jpol = JPolicy(2, 2, hiddens=HIDDENS)
    jparams = [jpol.init(jax.random.key(i)) for i in range(B)]
    jparams = [dict(p, sigma=jnp.asarray([0.3 * i - 0.2, -40.0]))
               for i, p in enumerate(jparams)]        # -40: the clamp
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jparams)
    rng = np.random.default_rng(0)
    s = rng.normal(size=(B, 20, 2)).astype(np.float32)
    a = rng.normal(size=(B, 20, 2)).astype(np.float32)
    want_loc, want_scale = jax.vmap(jpol.density)(stacked, s)
    want_lp = jax.vmap(jpol.log_prob)(stacked, s, a)
    pol = DiagNormalPolicy(2, 2, hiddens=HIDDENS)
    tparams = params_from_jax(stacked, "cpu")
    loc, scale = pol.density(tparams, _t(s))
    _close(loc, want_loc)
    _close(scale, want_scale)
    assert float(scale[0, 0, 1]) == pytest.approx(math.exp(MIN_LOG_SIGMA))
    _close(pol.log_prob(tparams, _t(s), _t(a)), want_lp, rel=1e-5)
    # shared params against a [B, N] batch of states
    shared = params_from_jax(jparams[1], "cpu")
    _close(pol.density(shared, _t(s))[0],
           jax.vmap(lambda x: jpol.density(jparams[1], x)[0])(s))


def test_normal_kl_and_log_prob_match_jax():
    rng = np.random.default_rng(1)
    lp, lq, v = (rng.normal(size=(5, 2)).astype(np.float32) for _ in range(3))
    sp, sq = (rng.uniform(0.2, 2.0, size=(5, 2)).astype(np.float32)
              for _ in range(2))
    _close(tdist.normal_kl(_t(lp), _t(sp), _t(lq), _t(sq)),
           jdist.normal_kl(lp, sp, lq, sq), rel=1e-6)
    _close(tdist.normal_log_prob(_t(lp), _t(sp), _t(v)),
           jdist.normal_log_prob(lp, sp, v), rel=1e-6)


def test_policy_init_and_sample():
    pol = DiagNormalPolicy(2, 2)
    params = pol.init(torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(l["w"].shape) for l in params["mean"]] == [
        (2, 100), (100, 100), (100, 2)]
    bound = math.sqrt(6.0 / 200)
    assert float(params["mean"][1]["w"].abs().max()) <= bound
    assert float(params["mean"][1]["w"].abs().max()) > 0.9 * bound
    assert all(float(l["b"].abs().max()) == 0 for l in params["mean"])
    assert params["sigma"].tolist() == [0.0, 0.0]
    obs = torch.zeros(4000, 2)
    acts = pol.sample(params, torch.Generator().manual_seed(1), obs)
    loc, _ = pol.density(params, obs)
    assert abs(float((acts - loc).std()) - 1.0) < 0.05


# -- value baseline and advantages ----------------------------------------------

@pytest.fixture(scope="module")
def traj_pair():
    jtraj, _ = _jax_trajectories(2)
    return jtraj, _to_torch(jtraj)


def test_linear_value_fit_predictions_match_jax(traj_pair):
    jtraj, traj = traj_pair
    flat = lambda x: x.reshape((B, T * E) + x.shape[3:])
    jflat = lambda x: jnp.reshape(x, (B, T * E) + x.shape[3:])
    ret = np.random.default_rng(3).normal(size=(B, T * E)).astype(np.float32)
    for reg in (1e-5, 2.0):
        jw = jax.vmap(lambda s, t, r, w: jvalue.fit_linear_value(
            s, t, r, reg=reg, weights=w))(jflat(jtraj.state),
                                          jflat(jtraj.timestep), ret,
                                          jflat(jtraj.valid))
        want = jax.vmap(jvalue.linear_value)(jw, jflat(jtraj.state),
                                             jflat(jtraj.timestep))
        w = tvalue.fit_linear_value(flat(traj.state), flat(traj.timestep),
                                    _t(ret), reg=reg,
                                    weights=flat(traj.valid))
        got = tvalue.linear_value(w, flat(traj.state), flat(traj.timestep))
        assert not w.requires_grad and w.shape == (B, 8, 1)
        # an ill-conditioned 8x8 f32 solve: compare fitted values
        _close(got, want, rel=2e-4)


@pytest.mark.parametrize("flat_timestep", [False, True])
@pytest.mark.parametrize("value_reg", [1e-5, 2.0])
def test_traj_advantages_match_jax(traj_pair, flat_timestep, value_reg):
    jtraj, traj = traj_pair
    kw = dict(gamma=0.99, tau=0.95, flat_timestep=flat_timestep,
              value_reg=value_reg)
    jadv, _ = jax.vmap(lambda t: jrl.traj_advantages(
        t, jrl.RLConfig(**kw)))(jtraj)
    adv, w = trl.traj_advantages(traj, trl.RLConfig(**kw))
    assert adv.shape == (B, T, E) and w.shape == (B, 8, 1)
    _close(adv, jadv, rel=2e-4)
    # a given baseline is reused as it is
    adv2, w2 = trl.traj_advantages(traj, trl.RLConfig(**kw),
                                   update_vf=False, baseline_w=w)
    assert w2 is w
    torch.testing.assert_close(adv2, adv, rtol=0, atol=0)


def test_masked_normalize_and_mean_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, 30)).astype(np.float32)
    mask = (rng.uniform(size=(B, 30)) < 0.7).astype(np.float32)
    mask[2] = 0.0
    mask[2, 5] = 1.0              # n = 1: the Bessel count floors at 2
    _close(trl.masked_normalize(_t(x), _t(mask)),
           jax.vmap(jrl.masked_normalize)(x, mask), rel=1e-5)
    _close(trl.masked_mean(_t(x), _t(mask)),
           jax.vmap(jrl.masked_mean)(x, mask), rel=1e-6)


# -- conjugate gradient and HVP ---------------------------------------------------

@pytest.mark.parametrize("rank", [12, 3])
def test_conjugate_gradient_matches_jax(rank):
    """rank 3: CG converges in 3 steps, so the JAX loop exits early and
    the port's where-frozen loop must give the same x."""
    rng = np.random.default_rng(rank)
    q, _ = np.linalg.qr(rng.normal(size=(12, 12)))
    eig = np.linspace(0.5, 3.0, 12)
    a = (q * eig) @ q.T
    b = q[:, :rank] @ rng.normal(size=rank)
    a, b = a.astype(np.float32), b.astype(np.float32)
    want = jcg.conjugate_gradient(lambda v: jnp.asarray(a) @ v,
                                  jnp.asarray(b), num_iterations=10)
    got = tcg.conjugate_gradient(lambda v: _t(a) @ v, _t(b),
                                 num_iterations=10)
    _close(got, want, rel=1e-5)
    _close(_t(a) @ got, b, rel=1e-4)


def test_hvp_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=7).astype(np.float32)
    v = rng.normal(size=7).astype(np.float32)
    jf = lambda z: jnp.sum(jnp.sin(z) * z ** 2) + jnp.sum(z) ** 2
    tf = lambda z: torch.sum(torch.sin(z) * z ** 2) + torch.sum(z) ** 2
    want = jcg.hvp(jf, jnp.asarray(x), damping=0.1)(jnp.asarray(v))
    Ax = tcg.hvp(tf, _t(x), damping=0.1)
    _close(Ax(_t(v)), want, rel=1e-5)
    _close(Ax(_t(v)), want, rel=1e-5)    # the graph is kept between calls
