"""Fused meta-RL training of the PyTorch port (``rl/train_scan.py``,
``--fuse N``) and its host-free TRPO line search, on the CPU.

- ``RLTrainer`` with ``--fuse 3`` for 5 iterations (chunks of 3 and 2)
  gives the ``--fuse 1`` run's ``metrics.json`` rows and ``model.npz`` bit
  for bit, for TRPO, PPO and VPG, MAML and ANIL; checkpoints land on the
  chunk-end iterations that JAX's fused driver picks.
- The host-free line search (all candidates evaluated, the first accepted
  one selected on the device) against JAX's ``meta_optimize_trpo``
  (a ``lax.while_loop`` that stops at the first accepted candidate), and
  bit for bit against the port's early-exit search, when the first
  candidate is accepted, when the first three are rejected, and when none
  is. Params are held at 2e-2 of the step (``test_torch_rl_trpo.py``: f32
  CG on a Fisher damped by 1e-5 amplifies last-bit differences).

Small size: 2-3 tasks, 3-4 episodes, 8-12 steps.
"""

import json
import os

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
from exploring_meta_tpu.trainers.fused import drive_fused_chunks as jax_drive
from exploring_meta_tpu_torch.envs.particles2d import Particles2D
from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
from exploring_meta_tpu_torch.rl import adapt_rl as trl
from exploring_meta_tpu_torch.rl import train_scan as tts
from exploring_meta_tpu_torch.rl import trpo_meta as ttm
from exploring_meta_tpu_torch.rl.rollout import Trajectory, make_rollout
from exploring_meta_tpu_torch.trainers.rl import RLTrainer, rl_config
from exploring_meta_tpu_torch.utils.bridge import params_from_jax
from exploring_meta_tpu_torch.utils.config import RLScriptConfig
from exploring_meta_tpu_torch.utils.tree import tree_leaves, tree_map

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these small runs only lose to the contention of
    several test workers' thread pools on the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SMALL = dict(meta_batch_size=2, adapt_batch_size=3, max_path_length=8,
             n_eval_tasks=2, outer_lr=0.01)


def _run(tmp_path, fuse, algo, anil):
    cfg = RLScriptConfig(fuse=fuse, num_iterations=5, save_every=2, **SMALL)
    trainer = RLTrainer(cfg, algo=algo, anil=anil,
                        path=str(tmp_path / f"f{fuse}") + "/", device="cpu")
    final = trainer.run()
    run = trainer.model_path
    with open(os.path.join(run, "metrics.json")) as f:
        metrics = json.load(f)
    with np.load(os.path.join(run, "model.npz")) as z:
        model = {k: z[k] for k in z.files}
    return final, metrics, model, sorted(os.listdir(
        os.path.join(run, "model_checkpoints")))


def _jax_checkpoints(total, fuse, save_every):
    its = []
    jax_drive(total=total, fuse=fuse, save_every=save_every,
              key=jax.random.key(0), state=0,
              run_chunk=lambda n, s, k: (s, {"x": jnp.zeros(n)}),
              log_step=lambda ms, j: None, postfix=lambda ms: {},
              save_ckpt=lambda s, i, k: its.append(i),
              progress=type("P", (), {"update": lambda self, n: None,
                                      "set_postfix": lambda self, d: None})())
    return [f"model_{i}.npz" for i in its]


@pytest.mark.parametrize("algo", ["trpo", "ppo", "vpg"])
@pytest.mark.parametrize("anil", [False, True], ids=["maml", "anil"])
def test_rl_fuse_3_matches_fuse_1_bit_for_bit(tmp_path, algo, anil):
    f1, m1, z1, c1 = _run(tmp_path, 1, algo, anil)
    f3, m3, z3, c3 = _run(tmp_path, 3, algo, anil)
    assert m3 == m1 and f3 == f1
    assert len(m1["meta_loss"]) == 5
    keys = {"trpo": ["adapt_reward", "adapt_success", "meta_loss",
                     "ls_accepted"],
            }.get(algo, ["meta_loss", "adapt_reward", "adapt_success"])
    assert list(m3) == keys + ["eval_reward", "eval_success"]
    assert z1.keys() == z3.keys()
    for k in z1:
        np.testing.assert_array_equal(z3[k], z1[k])
    assert c1 == ["model_0.npz", "model_2.npz", "model_4.npz"]
    assert c3 == _jax_checkpoints(5, 3, 2) == ["model_2.npz", "model_4.npz"]


def test_train_scans_keep_jax_metric_keys_and_bind_their_state():
    env, policy = Particles2D(), DiagNormalPolicy(2, 2, hiddens=(8, 8))
    cfg = rl_config(RLScriptConfig(adapt_batch_size=2, max_path_length=5))
    roll = make_rollout(env, policy.sample, 2, 5)
    gen = torch.Generator().manual_seed(0)
    params = policy.init(gen, device="cpu")
    train = tts.make_trpo_train_scan(env, policy, roll, cfg,
                                     ttm.TRPOConfig(), 2, 3)
    before = [t.clone() for t in tree_leaves(params)]
    out, ms = train(params, gen, 2)
    assert out is params and list(ms) == ["adapt_reward", "adapt_success",
                                          "meta_loss", "ls_accepted"]
    assert all(v.shape == (2,) for v in ms.values())
    assert any(not torch.equal(a, b)
               for a, b in zip(before, tree_leaves(params)))
    with pytest.raises(ValueError, match="bound"):
        train(tree_map(torch.clone, params), gen)
    p = tree_map(torch.Tensor.requires_grad_, policy.init(gen, device="cpu"))
    from exploring_meta_tpu_torch.adapt.maml import adam
    opt = adam(p, 1e-3)
    train = tts.make_adam_train_scan(env, policy, roll, cfg, "vpg", 2, 3)
    _, _, ms = train(p, opt, gen)
    assert list(ms) == ["meta_loss", "adapt_reward", "adapt_success"]
    assert all(v.shape == (3,) and bool(torch.isfinite(v).all())
               for v in ms.values())


# --------------------------------------------------------------------------
# the host-free line search against JAX
# --------------------------------------------------------------------------

B, E, T = 3, 4, 12
HIDDENS = (32, 32)
JCFG = jrl.RLConfig(inner_lr=0.05, adapt_steps=1, adapt_batch_size=E,
                    max_path_length=T)
TCFG = trl.RLConfig(inner_lr=0.05, adapt_steps=1, adapt_batch_size=E,
                    max_path_length=T)


def _leaves(tree):
    """Torch or JAX params -> flat float64 numpy, in the JAX leaf order."""
    if isinstance(tree, dict) and isinstance(tree.get("sigma"), torch.Tensor):
        tree = tree_map(lambda t: t.detach().numpy(), tree)
    return np.concatenate([np.asarray(x, np.float64).ravel()
                           for x in jax.tree_util.tree_leaves(tree)])


@pytest.fixture(scope="module")
def outer():
    """Meta params, the collection-time adapted params of a nearby policy,
    and stacked replays collected by JAX, on both sides."""
    jpol = JPolicy(2, 2, hiddens=HIDDENS)
    jparams = jpol.init(jax.random.key(0))
    goals = jnp.asarray(np.random.default_rng(0).uniform(
        -0.3, 0.3, size=(B, 2)), jnp.float32)
    roll = lambda p, g, k: jrollout(JEnv(), jpol.sample, p, g, k, E, T)
    keys = jax.random.split(jax.random.key(1), 2 * B).reshape(2, B)
    trajs = [jax.vmap(roll, (None, 0, 0))(jparams, goals, k) for k in keys]
    near = jax.tree_util.tree_map(
        lambda x: x + 0.01 * jax.random.normal(jax.random.key(3), x.shape),
        jparams)
    calls = iter(trajs)
    collect = jax.jit(jrl.trpo_collect_body(
        jpol, lambda p, t, k: jax.tree_util.tree_map(
            lambda x: x[t.astype(jnp.int32)], next(calls)), JCFG))
    jold, _, jrep, _ = collect(near, jnp.arange(B, dtype=jnp.float32),
                               jax.random.split(jax.random.key(2), B))
    rep = Trajectory(*(torch.as_tensor(np.array(x)) for x in jrep))
    return (jpol, jparams, jold, jrep, params_from_jax(jparams, "cpu"),
            params_from_jax(jold, "cpu"), rep)


# (outer_lr, ls_max_steps) -> surrogate evaluations of the early-exit
# search before it stops (the first is the old loss). Along this step the
# KL is 22.5, 1.55, 0.091 and 0.0069 at step sizes 1, 1/2, 1/4 and 1/8
# (max_kl 0.01), and the surrogate improves at 1/2 and below: the first
# candidate is accepted at outer_lr 0.1; at 1.0 three are rejected and
# the fourth accepted; of two at 1.0 none is.
LINE_SEARCH = {"first": ((0.1, 15), 2), "fourth": ((1.0, 15), 5),
               "none": ((1.0, 2), 3)}


@pytest.mark.parametrize("case", list(LINE_SEARCH))
def test_host_free_line_search_matches_jax(outer, monkeypatch, case):
    (outer_lr, steps), evals = LINE_SEARCH[case]
    jpol, jparams, jold, jrep, params, old, rep = outer
    trpo = dict(outer_lr=outer_lr, max_kl=0.01, ls_max_steps=steps,
                backtrack_factor=0.5, cg_iterations=10, damping=1e-5)
    jnew, jinfo = jtm.make_trpo_meta_step(jpol, JCFG, jtm.TRPOConfig(**trpo),
                                          1)(jparams, jold, jrep)
    pol = DiagNormalPolicy(2, 2, hiddens=HIDDENS)
    calls, plain = [], ttm.meta_surrogate_loss
    monkeypatch.setattr(ttm, "meta_surrogate_loss",
                        lambda *a: calls.append(1) or plain(*a))
    early, einfo = ttm.meta_optimize_trpo(pol, params, old, rep, TCFG,
                                          ttm.TRPOConfig(**trpo), 1)
    assert len(calls) == evals
    calls.clear()
    new, info = ttm.make_trpo_meta_step(pol, TCFG, ttm.TRPOConfig(**trpo), 1,
                                        host_free=True)(params, old, rep)
    assert len(calls) == 1 + steps      # every candidate, no early exit
    # a device bool, equal to the early-exit search's and to JAX's
    assert isinstance(info["accepted"], torch.Tensor)
    assert info["accepted"].dtype == torch.bool
    assert bool(info["accepted"]) == einfo["accepted"] == bool(
        jinfo["accepted"]) == (case != "none")
    assert float(info["old_loss"]) == float(einfo["old_loss"])
    for a, b in zip(tree_leaves(new), tree_leaves(early)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    step = _leaves(jnew) - _leaves(jparams)
    if case == "none":
        assert not step.any()
        np.testing.assert_array_equal(_leaves(new), _leaves(params))
        return
    # the same candidate as JAX's: the next one would be half (or twice)
    # the step, far outside 2e-2
    err = np.linalg.norm(_leaves(new) - _leaves(jnew))
    assert err <= 2e-2 * np.linalg.norm(step), err / np.linalg.norm(step)
