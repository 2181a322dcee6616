"""bf16 meta-RL (``--bf16``) of the PyTorch port vs the JAX package, on the
CPU: the policies' ``compute_dtype``, one bf16 MAML-TRPO collection and
outer step on identical replays, and ``--bf16`` runs from argv.

Tolerances. Each bf16 layer rounds a float32 dot product to bfloat16, and
JAX's and PyTorch's CPU GEMMs sum in different orders: where the exact dot
lies within float32 rounding of a bf16 rounding boundary (a tie) the two
may round to neighbouring bf16 values. So ``density`` is held to 1e-6 of
max|loc| (measured: equal) on every state but those whose forward provably
has a tie, of which at most 1 % may differ, by at most four bf16 steps of
max|loc|. Gradients go through bf16 matmuls too, summed over every
sample: the inner step is held to four bf16 steps (4 x 2^-8) of its move
(measured 7.6e-3). CG then amplifies the bf16 rounding of the
Fisher-vector products as it amplifies float32's (ROADMAP Queue 3), by
2^16 more: on these replays JAX's own jitted and eager bf16 outer steps
differ by 6.9e-2 of the step, the port's from JAX's by 0.149, and bf16's
from float32's by 0.45 (JAX) and 0.42 (the port). So the outer step is
held within 0.25 of the step, and to less than half bf16's distance from
float32.
"""

import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_meta_tpu.envs.particles2d import Particles2D as JEnv
from exploring_meta_tpu.models.policies import DiagNormalPolicy as JPolicy
from exploring_meta_tpu.models.policies import DiagNormalPolicyANIL as JANIL
from exploring_meta_tpu.rl import adapt_rl as jrl
from exploring_meta_tpu.rl import trpo_meta as jtm
from exploring_meta_tpu.rl.rollout import rollout as jrollout
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))
import chip_smoke  # noqa: E402  (bf16_tie_rows)
from exploring_meta_tpu_torch import cli  # noqa: E402
from exploring_meta_tpu_torch.adapt.maml import per_task
from exploring_meta_tpu_torch.models.policies import (
    DiagNormalPolicy, DiagNormalPolicyANIL,
)
from exploring_meta_tpu_torch.rl import adapt_rl as trl
from exploring_meta_tpu_torch.rl import trpo_meta as ttm
from exploring_meta_tpu_torch.rl.rollout import Trajectory
from exploring_meta_tpu_torch.utils.bridge import params_from_jax
from exploring_meta_tpu_torch.utils.tree import tree_items, tree_leaves

N_STATES = 2000
DENSITY_TOL, TIE_SHARE, BF16_STEPS = 1e-6, 0.01, 4 * 2.0 ** -8


def _jax_params(kind: str):
    """JAX init params with a perturbation, so that biases are not zero."""
    jpol = (JPolicy(2, 2, hiddens=(32, 32)) if kind == "mlp"
            else JANIL(2, 2, fc_neurons=32, hiddens=(32, 32)))
    return jpol, jax.tree_util.tree_map(
        lambda x: x + 0.1 * jax.random.normal(jax.random.key(4), x.shape),
        jpol.init(jax.random.key(1)))


def _port(kind: str, **kw):
    return (DiagNormalPolicy(2, 2, hiddens=(32, 32), **kw) if kind == "mlp"
            else DiagNormalPolicyANIL(2, 2, fc_neurons=32, hiddens=(32, 32),
                                      **kw))


def _layers(kind: str, params):
    """The bf16 forward's layers and activations, for
    ``chip_smoke.bf16_tie_rows``."""
    if kind == "mlp":
        return params["mean"], ["relu", "relu", None]
    return list(params["body"]) + [params["head"]], ["tanh", "tanh", None]


@pytest.mark.parametrize("kind", ["mlp", "anil"])
def test_bf16_density_and_log_prob_match_jax(kind):
    jpol, jparams = _jax_params(kind)
    rng = np.random.default_rng(0)
    states = rng.uniform(-0.6, 0.6, (N_STATES, 2)).astype(np.float32)
    actions = rng.normal(0, 0.3, (N_STATES, 2)).astype(np.float32)
    jb = jpol._replace(compute_dtype="bf16")
    jloc, jscale = jb.density(jparams, jnp.asarray(states))
    jlp = jb.log_prob(jparams, jnp.asarray(states), jnp.asarray(actions))
    pol = _port(kind, compute_dtype="bf16")
    params = params_from_jax(jparams, "cpu")
    loc, scale = pol.density(params, torch.as_tensor(states))
    lp = pol.log_prob(params, torch.as_tensor(states),
                      torch.as_tensor(actions))
    assert loc.dtype == scale.dtype == lp.dtype == torch.float32
    jloc, jlp = np.asarray(jloc), np.asarray(jlp)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    err = np.abs(loc.numpy() - jloc).max(axis=-1) / np.abs(jloc).max()
    lp_err = np.abs(lp.numpy() - jlp)[:, 0] / np.abs(jlp).max()
    differ = (err > DENSITY_TOL) | (lp_err > DENSITY_TOL)
    layers, acts = _layers(kind, params)
    tie = chip_smoke.bf16_tie_rows(torch, layers, acts,
                                   torch.as_tensor(states)).numpy()
    assert tie[differ].all(), np.flatnonzero(differ & ~tie)
    assert differ.mean() <= TIE_SHARE and err.max() <= BF16_STEPS, (
        differ.mean(), err.max())
    # bf16 is not f32: the two computations differ by ~2^-8 of max|loc|
    loc32, _ = _port(kind).density(params, torch.as_tensor(states))
    gap = float((loc32 - loc).abs().max() / loc32.abs().max())
    assert 1e-4 < gap < 3e-2, gap


def test_bf16_per_task_params_and_the_stop_body_grad():
    """Per-task ``[B]`` params run each task's MLP on its own params; the
    ANIL head's bf16 inputs are the same with and without
    ``stop_body_grad``."""
    for kind in ("mlp", "anil"):
        _, jparams = _jax_params(kind)
        pol = _port(kind, compute_dtype="bf16")
        params = params_from_jax(jparams, "cpu")
        states = torch.rand(3, 50, 2) - 0.5
        loc, _ = pol.density(per_task(params, 3), states)
        for b in range(3):
            torch.testing.assert_close(loc[b], pol.density(params,
                                                           states[b])[0],
                                       rtol=0, atol=0)
        if kind == "anil":
            torch.testing.assert_close(
                pol.density(params, states[0], stop_body_grad=True)[0],
                loc[0], rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["mlp", "anil"])
def test_bf16_gradients_reach_the_f32_leaves_as_f32(kind):
    _, jparams = _jax_params(kind)
    params = params_from_jax(jparams, "cpu")
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    states, actions = torch.rand(64, 2) - 0.5, torch.randn(64, 2) * 0.3
    lp = _port(kind, compute_dtype="bf16").log_prob(params, states, actions)
    grads = torch.autograd.grad(lp.sum(), leaves)
    for (key, leaf), g in zip(tree_items(params), grads):
        assert leaf.dtype == g.dtype == torch.float32, key
        assert float(g.abs().max()) > 0, key
    # the f32 policy's gradient, to bf16's precision
    grads32 = torch.autograd.grad(
        _port(kind).log_prob(params, states, actions).sum(), leaves)
    l2 = lambda gs: sum(float(g.double().square().sum()) for g in gs) ** 0.5
    gap = l2([g - g32 for g, g32 in zip(grads, grads32)]) / l2(grads32)
    assert 1e-4 < gap < 5e-2, gap


# ---------------------------------------------------------------------------
# bf16 MAML-TRPO on identical replays
# ---------------------------------------------------------------------------

B, E, T = 3, 4, 12
HIDDENS = (32, 32)
JCFG = jrl.RLConfig(inner_lr=0.05, adapt_batch_size=E, max_path_length=T)
TCFG = trl.RLConfig(inner_lr=0.05, adapt_batch_size=E, max_path_length=T)
TRPO = dict(outer_lr=0.1, max_kl=0.01, ls_max_steps=15,
            backtrack_factor=0.5, cg_iterations=10, damping=1e-5)


def _leaves(tree):
    if isinstance(tree, dict) and isinstance(tree.get("sigma"), torch.Tensor):
        tree = {k: v for k, v in tree_items(tree)}
        return np.concatenate([tree[k].detach().double().numpy().ravel()
                               for k in sorted(tree)])
    return np.concatenate([np.asarray(v, np.float64).ravel()
                           for _, v in sorted(tree_items(tree))])


def test_bf16_trpo_collection_and_outer_step_match_jax():
    jpol = JPolicy(2, 2, hiddens=HIDDENS, compute_dtype="bf16")
    jparams = jpol.init(jax.random.key(0))
    goals = jnp.asarray(np.random.default_rng(0).uniform(
        -0.3, 0.3, size=(B, 2)), jnp.float32)
    roll = lambda p, g, k: jrollout(JEnv(), jpol.sample, p, g, k, E, T)
    keys = jax.random.split(jax.random.key(1), 2 * B).reshape(2, B)
    support = jax.vmap(roll, (None, 0, 0))(jparams, goals, keys[0])
    query = jax.vmap(roll, (None, 0, 0))(jparams, goals, keys[1])

    def roll_for(trajs):
        return lambda p, task, k: jax.tree_util.tree_map(
            lambda x: jnp.asarray(x)[task.astype(jnp.int32)], trajs)
    calls = iter([roll_for(support), roll_for(query)])
    ja, jloss, jrep, _ = jax.jit(jrl.trpo_collect_body(
        jpol, lambda p, t, k: next(calls)(p, t, k), JCFG))(
            jparams, jnp.arange(B, dtype=jnp.float32),
            jax.random.split(jax.random.key(2), B))

    pol = DiagNormalPolicy(2, 2, hiddens=HIDDENS, compute_dtype="bf16")
    params = params_from_jax(jparams, "cpu")
    it = iter([Trajectory(*(torch.as_tensor(np.array(x)) for x in tr))
               for tr in (support, query)])
    adapted, loss, rep, _ = trl.trpo_collect_body(
        pol, lambda p, t, g: next(it), TCFG)(params, torch.arange(B).float(),
                                             None)
    for name in Trajectory._fields:
        np.testing.assert_array_equal(getattr(rep, name).numpy(),
                                      np.asarray(getattr(jrep, name)))
    step = _leaves(ja) - _leaves(jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), jparams))
    inner = np.abs(_leaves(adapted) - _leaves(ja)).max() / np.abs(step).max()
    assert inner <= BF16_STEPS, inner
    assert np.abs(loss.numpy() - np.asarray(jloss)).max() <= (
        BF16_STEPS * np.abs(np.asarray(jloss)).max())

    jnew, jinfo = jtm.make_trpo_meta_step(jpol, JCFG, jtm.TRPOConfig(**TRPO),
                                          1)(jparams, ja, jrep)
    new, info = ttm.meta_optimize_trpo(pol, params, adapted, rep, TCFG,
                                       ttm.TRPOConfig(**TRPO), 1)
    assert info["accepted"] == bool(jinfo["accepted"]) is True
    assert info["index"] >= 0
    outer = _leaves(jnew) - _leaves(jparams)
    assert np.linalg.norm(outer) > 1e-3
    err = np.linalg.norm(_leaves(new) - _leaves(jnew)) / np.linalg.norm(outer)
    assert err <= 0.25, err
    new32, _ = ttm.meta_optimize_trpo(DiagNormalPolicy(2, 2, hiddens=HIDDENS),
                                      params, adapted, rep, TCFG,
                                      ttm.TRPOConfig(**TRPO), 1)
    gap = np.linalg.norm(_leaves(new32) - _leaves(jnew)) / np.linalg.norm(
        outer)
    assert err < 0.5 * gap, (err, gap)


def _run_dir(path):
    (run,) = os.listdir(path)
    return os.path.join(path, run)


@pytest.mark.parametrize("command", ["maml_trpo", "maml_ppo", "anil_vpg"])
def test_bf16_from_argv_eager_and_fused(tmp_path, monkeypatch, command):
    """``--bf16`` from argv, eager and ``--fuse 2``: on the CPU a fused
    chunk runs its iterations eagerly, so both runs write the same
    ``metrics.json`` rows and ``model.npz`` bit for bit; both differ from
    the float32 run."""
    monkeypatch.setenv("EMT_FORCE_CPU", "1")
    argv = ["--num_iterations", "2", "--meta_batch_size", "2",
            "--adapt_batch_size", "3", "--max_path_length", "8",
            "--n_eval_tasks", "2", "--fc_neurons", "16", "--outer_lr",
            "0.01" if command != "maml_trpo" else "0.1"]
    models, rows = {}, {}
    for name, extra in (("eager", ["--bf16"]), ("fused", ["--bf16", "--fuse",
                                                          "2"]),
                        ("f32", [])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        final = cli.COMMANDS[command](argv + extra)
        assert math.isfinite(final["mean_reward"])
        run = _run_dir(str(tmp_path / name / "results"))
        with open(os.path.join(run, "logger.json")) as f:
            assert json.load(f)["config"]["bf16"] == (name != "f32")
        with open(os.path.join(run, "metrics.json")) as f:
            rows[name] = json.load(f)
        with np.load(os.path.join(run, "model.npz")) as z:
            models[name] = {k: z[k] for k in z.files}
    loss = "meta_loss"
    assert rows["eager"][loss] == rows["fused"][loss]
    assert all(math.isfinite(v) for v in rows["eager"][loss])
    for k in models["eager"]:
        np.testing.assert_array_equal(models["eager"][k], models["fused"][k])
    assert any(not np.array_equal(models["eager"][k], models["f32"][k])
               for k in models["f32"])
