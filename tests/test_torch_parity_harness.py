"""The port's parity harness (``parity/check.py``) against the JAX one
(``scripts/parity_check.py``), end to end on the CPU: the same initial
params and the same task batches or replays go through both harnesses,
and what each trains is held against the other.

The reproductions of the reference are held against the scripts' in
``test_torch_parity.py``; here they are left out, and what is held is the
harness's wiring: which dataset and split it samples, the model and
fast-adapt it builds (MAML / ANIL, ``--bf16``'s ``cast_compute``), the
optimizer and its learning rates, the RL config (reference-exact D9
switches) and the order of collection and outer step.

Vision: ``main`` of each harness at one meta-step of 2 tasks and one
eval batch of 2 tasks, Omniglot-shaped at full width; JAX's init and its
sampled batches are recorded and the port is given the same. Held: the
split each batch comes from, the meta-step's loss, the trained params the
eval is given (so the learning rate and the optimizer) and the eval's
loss and accuracy; under ``--bf16`` that ``cast_compute`` wraps the
fast-adapt. RL: one iteration of ``run_jax_rl`` / ``run_port_rl`` at a
small config on fixed JAX trajectories (support, then query) replayed by
index, both meta-tests recording their params; held: the trained params.

Tolerances. f32: the loss within 1e-5 relative, as
``test_torch_vision_meta.py`` holds a meta-step. Adam's first update is
~lr * sign(g): a conv bias, whose gradient is zero in exact arithmetic,
steps either way (BN removes it, so no loss sees it), and so may a
weight whose gradient is at rounding level (1 of 110,000 elements
measured), which moves the eval loss by 4e-5 relative (held to 3e-4).
bf16 as measured below. RL, the trained params' distance from JAX's
against JAX's step: PPO / VPG (one Adam step) 1e-3, measured 8.5e-6 to
1.3e-4; TRPO 5e-2, measured 2.75e-2 (MAML) and 1.66e-2 (ANIL). A TRPO
step solves a float32 CG on a damped Fisher, which amplifies last-bit
differences (``test_torch_rl_trpo.py``); here the two linear-baseline
solves, torch's and XLA's, differ at ~1e-5 relative, while JAX's jitted
and eager harness, which share XLA's solve, differ by 8.6e-4 / 1.9e-3.
Against JAX in float64 JAX's own float32 TRPO step has lain 8-18 % of the
step away (``test_torch_multiseed_jax.py``). A wiring fault (a learning
rate, the KL bound, a D9 switch, the split of collection and outer step)
moves the step by a multiple of itself.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exploring_meta_tpu.adapt as jadapt
import exploring_meta_tpu.envs as jenvs
import exploring_meta_tpu.models as jmodels
import exploring_meta_tpu.rl as jrl
import exploring_meta_tpu.tasks as jtasks
from exploring_meta_tpu.rl.rollout import rollout as jrollout
from exploring_meta_tpu_torch.parity import check
from exploring_meta_tpu_torch.rl.rollout import Trajectory
from exploring_meta_tpu_torch.utils.bridge import params_from_jax
from exploring_meta_tpu_torch.utils.tree import tree_items

SCRIPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       os.pardir, "scripts")
sys.path.insert(0, SCRIPTS)
import parity_check as jpc  # noqa: E402

VISION_ARGV = ["--iters", "1", "--meta_batch", "2", "--eval_tasks", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CNN4 trains at full width here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(params) -> dict:
    return {k: np.asarray(v.detach() if torch.is_tensor(v) else v,
                          np.float64) for k, v in tree_items(params)}


def _float(x) -> float:
    return float(np.asarray(x.detach() if torch.is_tensor(x) else x))


def _run_jax_vision(argv, monkeypatch, capsys) -> dict:
    """``scripts/parity_check.py:main`` with the reference left out ->
    what its ``run_jax`` initialised, sampled and measured."""
    rec = {"init": None, "batches": [], "steps": [], "evals": []}
    init, sample = jmodels.init_cnn4, jtasks.sample_task_batch
    make_step, make_eval = jadapt.make_meta_step, jadapt.make_meta_eval

    def recording_init(key, spec):
        rec["init"] = jax.tree_util.tree_map(np.asarray, init(key, spec))
        return rec["init"]

    def recording_sample(key, ds, ways, shots, n):
        d, l = sample(key, ds, ways, shots, n)
        rec["batches"].append((np.asarray(ds.images), np.asarray(d),
                               np.asarray(l)))
        return d, l

    def recording_step(fa, opt):
        step = make_step(fa, opt)

        def run(*a):
            params, state, m = step(*a)
            rec["steps"].append(_float(m["loss"]))
            return params, state, m
        return run

    def recording_eval(fa):
        ev = make_eval(fa)

        def run(params, *a):
            out = ev(params, *a)
            rec["evals"].append((_float(out["loss"]), _float(out["metric"]),
                                 _leaves(params)))
            return out
        return run

    monkeypatch.setattr(jmodels, "init_cnn4", recording_init)
    monkeypatch.setattr(jtasks, "sample_task_batch", recording_sample)
    monkeypatch.setattr(jadapt, "make_meta_step", recording_step)
    monkeypatch.setattr(jadapt, "make_meta_eval", recording_eval)
    monkeypatch.setattr(jpc, "run_torch", lambda *a, **k: 0.0)
    monkeypatch.setattr(sys, "argv", ["parity_check.py"] + argv)
    jpc.main()
    capsys.readouterr()
    monkeypatch.undo()
    return rec


def _run_port_vision(argv, jax_rec, monkeypatch) -> dict:
    """The port's harness given JAX's init and batches -> what it
    sampled from and measured."""
    rec = {"datasets": [], "steps": [], "evals": [], "cast": 0}
    batches = iter(jax_rec["batches"])
    cast = check.cast_compute

    def recording_cast(fa):
        rec["cast"] += 1
        return cast(fa)

    make_step, make_eval = check.make_meta_step, check.make_meta_eval

    def replayed_sample(gen, ds, ways, shots, n):
        images, d, l = next(batches)
        rec["datasets"].append(np.array_equal(ds.images.cpu().numpy(),
                                              images))
        assert d.shape[0] == n
        return torch.from_numpy(d.copy()), torch.from_numpy(l).long()

    def recording_step(fa):
        step = make_step(fa)

        def run(*a):
            params, state, m = step(*a)
            rec["steps"].append(_float(m["loss"]))
            return params, state, m
        return run

    def recording_eval(fa):
        ev = make_eval(fa)

        def run(params, *a):
            out = ev(params, *a)
            rec["evals"].append((_float(out["loss"]), _float(out["metric"]),
                                 _leaves(params)))
            return out
        return run

    monkeypatch.setattr(check.cnn4, "init_cnn4", lambda gen, spec, device: (
        params_from_jax(jax_rec["init"], device)))
    monkeypatch.setattr(check, "sample_task_batch", replayed_sample)
    monkeypatch.setattr(check, "cast_compute", recording_cast)
    monkeypatch.setattr(check, "make_meta_step", recording_step)
    monkeypatch.setattr(check, "make_meta_eval", recording_eval)
    monkeypatch.setattr(check.reference_vision, "run_torch",
                        lambda *a, **k: 0.0)
    check.main(argv, device="cpu")
    return rec


@pytest.mark.parametrize("extra", [[], ["--anil"], ["--bf16"]],
                         ids=["maml", "anil", "maml_bf16"])
def test_vision_harness_trains_as_jaxs(extra, monkeypatch, capsys):
    argv = VISION_ARGV + extra
    want = _run_jax_vision(argv, monkeypatch, capsys)
    got = _run_port_vision(argv, want, monkeypatch)
    # the port sampled each batch from the split JAX did: train, then test
    assert got["datasets"] == [True, True]
    assert not np.array_equal(want["batches"][0][0], want["batches"][1][0])
    (loss,), (want_loss,) = got["steps"], want["steps"]
    ((*got_eval, params),) = got["evals"]
    ((*want_eval, want_params),) = want["evals"]
    assert params.keys() == want_params.keys()
    init = _leaves(want["init"])
    lr = check.parse_args(argv).outer_lr
    # Adam's first step moves no element by more than lr
    assert all(np.abs(p - init[k]).max() <= lr * (1 + 1e-4)
               for k, p in params.items())
    off = {k: np.abs(p - want_params[k]) > 0.1 * lr
           for k, p in params.items() if not k.endswith("conv/b")}
    n_off = sum(int(o.sum()) for o in off.values())
    n = sum(o.size for o in off.values())
    assert got["cast"] == ("--bf16" in extra)
    if "--bf16" not in extra:
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        np.testing.assert_allclose(got_eval[0], want_eval[0], rtol=3e-4)
        assert got_eval[1] == pytest.approx(want_eval[1], abs=1e-6)
        assert n_off <= 1e-4 * n, n_off
        return
    # bf16: the loss lies within 5e-2 of JAX's bf16 loss (measured
    # 3.3e-2; JAX's f32 loss lies 9e-2 from it); bf16 gradients near zero
    # change sign between the packages, so only most elements step as
    # JAX's do (measured 79 %)
    np.testing.assert_allclose(loss, want_loss, rtol=5e-2)
    assert n_off <= 0.3 * n, n_off / n


# ---------------------------------------------------------------------------
# RL: one iteration on replayed JAX trajectories
# ---------------------------------------------------------------------------

# Small, but not so small that the TRPO step is set by rounding: at 3
# tasks x 4 episodes x 12 steps the ANIL-TRPO gradient is so small that
# the port's own step on 1 and on 4 intra-op threads differs by 5.8x the
# step (the line search accepts its first and its fourth candidate); here
# the two agree within 6.4e-4 of the step.
SMALL_RL = {"num_iterations": 1, "meta_batch_size": 5, "n_eval_tasks": 2,
            "adapt_batch_size": 10, "max_path_length": 25}


def _trajectories(anil: bool, cfg: dict):
    """Per task a support and a query trajectory of JAX's untrained
    policy of the harness (numpy, ``[B, T, E, ...]``)."""
    policy = (jmodels.DiagNormalPolicyANIL(2, 2, fc_neurons=100) if anil
              else jmodels.DiagNormalPolicy(2, 2))
    params = policy.init(jax.random.key(5))
    b, e, t = (cfg["meta_batch_size"], cfg["adapt_batch_size"],
               cfg["max_path_length"])
    goals = jnp.asarray(np.random.default_rng(0).uniform(
        -0.5, 0.5, size=(b, 2)), jnp.float32)
    roll = lambda g, k: jrollout(jenvs.Particles2D(), policy.sample,  # noqa
                                 params, g, k, e, t)
    keys = jax.random.split(jax.random.key(6), 2 * b).reshape(2, b)
    return [jax.tree_util.tree_map(np.asarray, jax.vmap(roll)(goals, k))
            for k in keys]


def _run_jax_rl(algo, cfg, anil, trajs, monkeypatch) -> list:
    """``run_jax_rl`` with tasks as indices into ``trajs`` -> the params
    its two meta-tests were given (pre, post)."""
    seen, calls = [], iter(trajs)

    class Indexed(jenvs.Particles2D):
        def sample_tasks(self, key, n):
            return jnp.arange(n, dtype=jnp.float32)

    def make_rollout(env, sample, episodes, horizon):
        def roll(params, task, key):
            trajs = next(calls)
            return jax.tree_util.tree_map(
                lambda x: jnp.asarray(x)[task.astype(jnp.int32)], trajs)
        return roll

    def meta_test(algo, env, policy, params, cfg, n_tasks, key, seed):
        seen.append(jax.tree_util.tree_map(np.asarray, params))
        return {"mean_reward": 0.0}

    monkeypatch.setattr(jenvs, "Particles2D", Indexed)
    monkeypatch.setattr(jrl, "make_rollout", make_rollout)
    monkeypatch.setattr(jrl, "meta_test", meta_test)
    jpc.run_jax_rl(algo, cfg, 3, anil=anil)
    monkeypatch.undo()
    return seen


def _run_port_rl(algo, cfg, anil, trajs, init, monkeypatch) -> list:
    """``run_port_rl`` from JAX's ``init`` on the same replays -> the
    params its two meta-tests were given."""
    seen, calls = [], iter(trajs)
    name = "DiagNormalPolicyANIL" if anil else "DiagNormalPolicy"

    class FromJax(getattr(check, name)):
        def init(self, gen, device=None):
            return params_from_jax(init, "cpu")

    class Indexed(check.Particles2D):
        def sample_tasks(self, gen, n):
            return torch.arange(n, dtype=torch.float32)

    def make_rollout(env, sample, episodes, horizon):
        def roll(params, tasks, gen):
            return Trajectory(*(torch.from_numpy(np.array(x))
                                for x in next(calls)))
        return roll

    def meta_test(algo, env, policy, params, cfg, n_tasks, gen, seed):
        seen.append({k: v.detach().clone() for k, v in tree_items(params)})
        return {"mean_reward": 0.0}

    monkeypatch.setattr(check, name, FromJax)
    monkeypatch.setattr(check, "Particles2D", Indexed)
    monkeypatch.setattr(check, "make_rollout", make_rollout)
    monkeypatch.setattr(check, "meta_test", meta_test)
    check.run_port_rl(algo, cfg, 3, anil=anil, device="cpu")
    return seen


@pytest.mark.parametrize("anil", [False, True], ids=["maml", "anil"])
@pytest.mark.parametrize("algo", ["trpo", "ppo", "vpg"])
def test_rl_harness_trains_as_jaxs(algo, anil, monkeypatch):
    cfg = {**check.default_rl_cfg(algo), **SMALL_RL, "anil": anil}
    trajs = _trajectories(anil, cfg)
    jpre, jpost = _run_jax_rl(algo, dict(cfg), anil, trajs, monkeypatch)
    pre, post = _run_port_rl(algo, dict(cfg), anil, trajs, jpre,
                             monkeypatch)
    jpre, jpost, pre, post = map(_leaves, (jpre, jpost, pre, post))
    assert pre.keys() == jpre.keys() == post.keys() == jpost.keys()
    for k in jpre:
        np.testing.assert_array_equal(pre[k], jpre[k])
    step = np.concatenate([(jpost[k] - jpre[k]).ravel() for k in jpre])
    err = np.concatenate([(post[k] - jpost[k]).ravel() for k in jpre])
    assert np.linalg.norm(step) > 1e-3
    tol = 5e-2 if algo == "trpo" else 1e-3
    assert np.linalg.norm(err) <= tol * np.linalg.norm(step), (
        np.linalg.norm(err) / np.linalg.norm(step))
