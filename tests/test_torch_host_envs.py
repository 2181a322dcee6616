"""Host-physics envs of the port (``envs/host.py``) against the JAX
package's: ``HostVecEnv.collect`` under the same action table bit for bit
(a fake point env, and gymnasium's real MuJoCo Ant), the native pool
against the Python loop, the grouped ``[n_tasks, T, episodes]`` layout and
its per-task params, ``--host_policy cpu``, the worker count, a host TRPO
iteration on JAX's collected replays, and an ANIL-PPO Ant run end to end.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_meta_tpu.envs import host as jhost
from exploring_meta_tpu.models.policies import DiagNormalPolicy as JPolicy
from exploring_meta_tpu.rl import adapt_rl as jrl
from exploring_meta_tpu.rl import trpo_meta as jtm
from exploring_meta_tpu.utils.experiment import load_params as jload_params
from exploring_meta_tpu_torch.envs import host
from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
from exploring_meta_tpu_torch.rl.rollout import Trajectory
from exploring_meta_tpu_torch.trainers.rl import (
    RLTrainer, rl_config, trpo_config,
)
from exploring_meta_tpu_torch.utils.bridge import params_from_jax
from exploring_meta_tpu_torch.utils.config import RLScriptConfig
from exploring_meta_tpu_torch.utils.tree import tree_leaves, tree_map
from test_host_env import FakeHostEnv


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: small runs only lose to the contention of
    several test workers' thread pools, and the CPU build's multi-threaded
    solve of Ant's baseline fit (214 features) has been seen to hang after
    another test set the thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _collect(mod, factory, n_envs, table, task, backend, key):
    vec = mod.HostVecEnv(factory, n_envs, backend=backend, n_threads=2)
    vec.set_task(task)
    steps = iter(range(len(table)))
    traj = vec.collect(lambda k, o: table[next(steps)], key, len(table),
                       seed=3)
    return [np.asarray(x) for x in traj], vec.backend


def _same(a: list, b: list) -> None:
    assert len(a) == len(b) == 8
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("backend", ["python", "native"])
def test_collect_equals_jax_on_a_fake_env(backend):
    """Actions beyond the env's +-0.2 clip too: on the Python loop the env
    clips float32 actions at float32 bounds, on the pool float64 ones, in
    both packages alike."""
    table = np.random.default_rng(0).uniform(-0.3, 0.3, (12, 3, 1)).astype(
        np.float32)
    ours, b = _collect(host, FakeHostEnv, 3, table, np.array([0.5]),
                       backend, torch.Generator())
    theirs, jb = _collect(jhost, FakeHostEnv, 3, table, np.array([0.5]),
                          backend, jax.random.key(0))
    assert b == jb == backend
    _same(ours, theirs)
    assert ours[0].dtype == np.float32 and ours[7].dtype == np.int32
    # the episodes that end mid-column: done at the end, then filler
    valid, done = ours[6], ours[3]
    assert (valid == 0).any() and (done[-1] == 1).all()


def test_native_equals_the_python_loop_within_the_clip():
    table = np.random.default_rng(1).uniform(-0.2, 0.2, (12, 3, 1)).astype(
        np.float32)
    native, _ = _collect(host, FakeHostEnv, 3, table, np.array([0.4]),
                         "native", None)
    python, _ = _collect(host, FakeHostEnv, 3, table, np.array([0.4]),
                         "python", None)
    _same(native, python)


def test_collect_on_mujoco_ant_equals_jax():
    """gymnasium's Ant-v5 on real MuJoCo, 2 slots x 20 steps, actions
    beyond the action space (the env clamps them): the port's collection
    equals JAX's bit for bit on either backend. Native equals the loop but
    for the reward's last float32 bit: the loop hands the env float32
    actions and the pool float64 ones, and gymnasium's control cost is
    computed in the action's dtype (in JAX as here)."""
    pytest.importorskip("mujoco")
    table = np.random.default_rng(2).uniform(-1.5, 1.5, (20, 2, 8)).astype(
        np.float32)
    task = np.array([0.6, 0.8])
    got = {}
    for backend in ("python", "native"):
        ours, b = _collect(host, lambda: host.AntDirectionEnv(seed=5), 2,
                           table, task, backend, None)
        theirs, _ = _collect(jhost, lambda: jhost.AntDirectionEnv(seed=5), 2,
                             table, task, backend, jax.random.key(0))
        assert b == backend
        _same(ours, theirs)
        got[backend] = ours
    for i, (x, y) in enumerate(zip(got["native"], got["python"])):
        if i == 2:  # the reward
            np.testing.assert_allclose(x, y, rtol=2e-7, atol=2e-7)
        else:
            np.testing.assert_array_equal(x, y)
    assert got["native"][0].shape == (20, 2, 105)


class LinearStub:
    """A deterministic policy of the port's contract: action = w * the
    first observation (``w`` per task when stacked); ``sigma`` carries the
    task axis as the port's policies' does."""

    def sample(self, params, gen, obs):
        return obs[..., :1] * params["w"]


class JLinearStub:
    def sample(self, params, key, obs):
        return obs[..., :1] * params["w"]


def _fake_vec(mod, n, backend="native"):
    vec = mod.HostVecEnv(FakeHostEnv, n, backend=backend, n_threads=2)
    return vec


def test_grouped_layout_and_per_task_params_equal_jax():
    """``[n_tasks, T, episodes, ...]``, task i on slots ``[i * episodes,
    (i + 1) * episodes)`` under row i of the stacked params, bit for bit
    JAX's ``make_grouped_host_rollout`` (same deterministic policy)."""
    n, ep, T = 3, 2, 10
    tasks = np.array([[0.5], [-0.4], [0.8]])
    w = np.array([0.5, -1.0, 2.0], np.float32)
    roll = host.make_grouped_host_rollout(_fake_vec(host, n * ep),
                                          LinearStub(), T, n, ep)
    ours = roll({"w": torch.tensor(w).view(n, 1, 1),
                 "sigma": torch.zeros(n, 1)}, tasks, torch.Generator())
    jroll = jhost.make_grouped_host_rollout(_fake_vec(jhost, n * ep),
                                            JLinearStub(), T, n, ep)
    theirs = jroll({"w": jnp.asarray(w).reshape(n, 1, 1)}, list(tasks),
                   jax.random.key(0))
    assert ours.state.shape == (n, T, ep, 2)
    _same([x.numpy() for x in ours], [np.asarray(x) for x in theirs])
    # the second observation is the slot's goal; actions are w_i * x
    np.testing.assert_array_equal(
        ours.state[..., 1].numpy(),
        np.broadcast_to(tasks.astype(np.float32)[:, None], (n, T, ep)))
    first = ours.action[:, 1, :, 0].numpy()
    np.testing.assert_array_equal(
        first, w[:, None] * ours.state[:, 1, :, 0].numpy())
    with pytest.raises(ValueError, match="need 2 tasks x 2 episodes"):
        host.make_grouped_host_rollout(_fake_vec(host, 6), LinearStub(), T,
                                       2, 2)


def test_per_task_rollout_one_task_or_a_batch():
    """One task gives ``[T, E]`` (JAX's ``make_host_rollout``, bit for
    bit); a batch is collected task after task, row i of stacked params on
    task i, ``[B, T, E]``; dict tasks pass through."""
    T = 8
    roll = host.make_host_rollout(_fake_vec(host, 3), LinearStub(), T)
    jroll = jhost.make_host_rollout(_fake_vec(jhost, 3), JLinearStub(), T)
    one = roll({"w": torch.tensor([[1.5]]), "sigma": torch.zeros(1)},
               np.array([0.3]), torch.Generator())
    jone = jroll({"w": jnp.asarray([[1.5]])}, np.array([0.3]),
                 jax.random.key(0))
    assert one.state.shape == (T, 3, 2)
    _same([x.numpy() for x in one], [np.asarray(x) for x in jone])
    tasks = np.array([[0.3], [-0.6]])
    stacked = {"w": torch.tensor([[[1.5]], [[0.5]]]),
               "sigma": torch.zeros(2, 1)}
    batch = roll(stacked, tasks, torch.Generator())
    assert batch.state.shape == (2, T, 3, 2)
    for i in range(2):
        row = roll({"w": stacked["w"][i], "sigma": torch.zeros(1)},
                   tasks[i], torch.Generator())
        _same([x[i].numpy() for x in batch], [x.numpy() for x in row])
    with pytest.raises(TypeError):
        roll({"w": torch.ones(1, 1), "sigma": torch.zeros(1)},
             {"task": 0}, torch.Generator())  # FakeHostEnv takes arrays


def test_host_policy_cpu_equals_device_on_the_cpu():
    """JAX's ``test_cpu_policy_device_matches``: on the CPU the "cpu"
    placement draws from the rollout's own generator and the same params,
    so its trajectories equal the default's exactly."""
    policy = DiagNormalPolicy(2, 1, hiddens=(16, 16))
    params = policy.init(torch.Generator().manual_seed(0), device="cpu")
    vec = _fake_vec(host, 3)
    task = np.array([0.5])
    dev = host.make_host_rollout(vec, policy, 12)(
        params, task, torch.Generator().manual_seed(5))
    cpu = host.make_host_rollout(vec, policy, 12, policy_device="cpu")(
        params, task, torch.Generator().manual_seed(5))
    _same([x.numpy() for x in dev], [x.numpy() for x in cpu])
    host.reset_counts()
    host.make_grouped_host_rollout(vec, policy, 12, 1, 3)(
        params, [task], torch.Generator())
    assert host.COUNTS == {"steps": 12, "round_trips": 0, "shipments": 0}


def test_set_host_policy_device_validates(monkeypatch):
    monkeypatch.setattr(host, "_POLICY_DEVICE_MODE", "device")
    with pytest.raises(ValueError, match="'device' or 'cpu'"):
        host.set_host_policy_device("tpu9")
    with pytest.raises(ValueError, match="'device' or 'cpu'"):
        host._place_policy("gpu", {}, torch.Generator())
    host.set_host_policy_device("cpu")
    assert host._POLICY_DEVICE_MODE == "cpu"
    with pytest.raises(ValueError, match="unknown backend"):
        host.HostVecEnv(FakeHostEnv, 2, backend="threads")


def test_workers_are_counted_on_the_cpus_this_process_may_use(monkeypatch):
    """``auto`` takes the loop when one worker can run: ``n_threads=1``,
    or one CPU in the affinity mask (``os.sched_getaffinity``, not the
    machine's count); ``native`` takes the pool regardless."""
    assert host.HostVecEnv(FakeHostEnv, 4).backend == "native"
    assert host.HostVecEnv(FakeHostEnv, 4, n_threads=1).backend == "python"
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0})
    assert host.HostVecEnv(FakeHostEnv, 4).backend == "python"
    assert host.HostVecEnv(FakeHostEnv, 4,
                           backend="native").backend == "native"


def test_host_trpo_iteration_on_jax_replays(tmp_path):
    """The trainer's per-task host TRPO iteration fed JAX's per-task
    collection (support, query; task after task, as JAX collects):
    the outer step within 2e-2 of the step of JAX's, the same line-search
    outcome, the same adaptation reward."""
    cfg = RLScriptConfig(meta_batch_size=2, adapt_batch_size=3,
                         max_path_length=12, inner_lr=0.05)
    rl_cfg = rl_config(cfg)
    jcfg = jrl.RLConfig(**rl_cfg._asdict())
    jpolicy = JPolicy(input_size=2, output_size=1, hiddens=(16, 16))
    jparams = jpolicy.init(jax.random.key(0))
    jroll = jhost.make_host_rollout(_fake_vec(jhost, 3), jpolicy, 12)
    tasks = np.array([[0.5], [-0.3]])
    replays, olds, rews = [], [], []
    key = jax.random.key(1)
    for task in tasks:
        key, k = jax.random.split(key)
        adapted, _, replay, m = jrl.fast_adapt_trpo(jpolicy, jparams, jroll,
                                                    task, k, jcfg)
        replays.append(replay)
        olds.append(adapted)
        rews.append(float(m["reward"]))
    jnew, jinfo = jtm.make_trpo_meta_step(
        jpolicy, jcfg, jtm.TRPOConfig(**trpo_config(cfg)._asdict()),
        adapt_steps=1)(jparams,
                       jax.tree_util.tree_map(lambda *x: jnp.stack(x), *olds),
                       jtm.stack_replays(replays))
    fed = iter([t for r in replays for t in r])

    def feeder(params, task, gen):
        return Trajectory(*(torch.as_tensor(np.array(x))[None]
                            for x in next(fed)))

    class Tasks:
        def sample_tasks(self, gen, n):
            return tasks

    trainer = RLTrainer(cfg, algo="trpo", device="cpu",
                        path=str(tmp_path) + "/")
    step = trainer._make_host_trpo_iteration(
        Tasks(), DiagNormalPolicy(2, 1, hiddens=(16, 16)), feeder, rl_cfg)
    params = params_from_jax(jparams, "cpu")
    new, _, metrics = step(params, None, torch.Generator())
    flat = lambda tree: np.concatenate([np.asarray(x, np.float64).ravel()
                                        for x in tree])
    want = flat(jax.tree_util.tree_leaves(jnew))
    got = flat([t.detach() for t in tree_leaves(new)])
    step_norm = np.linalg.norm(want - flat(jax.tree_util.tree_leaves(
        jparams)))
    assert step_norm > 0
    assert np.linalg.norm(got - want) <= 2e-2 * step_norm
    assert bool(metrics["ls_accepted"]) == bool(jinfo["accepted"])
    assert float(metrics["adapt_reward"]) == pytest.approx(np.mean(rews),
                                                           rel=1e-6)


def test_anil_ppo_on_mujoco_ant_end_to_end(tmp_path, monkeypatch):
    """``anil_ppo --env AntDirection-v1`` from argv on the CPU (real
    MuJoCo; 2 iterations, 2 tasks x 2 episodes x 10 steps): finite rows
    and meta-test, a run dir the JAX package loads."""
    pytest.importorskip("mujoco")
    from exploring_meta_tpu.models.policies import DiagNormalPolicyANIL
    from exploring_meta_tpu_torch import cli
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("EMT_FORCE_CPU", "1")
    final = cli.anil_ppo(["--env", "AntDirection-v1", "--num_iterations",
                          "2", "--meta_batch_size", "2",
                          "--adapt_batch_size", "2", "--max_path_length",
                          "10", "--n_eval_tasks", "2", "--outer_lr", "0.01"])
    assert np.isfinite(final["mean_reward"])
    (run,) = os.listdir(tmp_path / "results")
    assert run.startswith("anil_ppo_AntDirection-v1_")
    path = tmp_path / "results" / run
    template = DiagNormalPolicyANIL(input_size=105, output_size=8,
                                    fc_neurons=100).init(jax.random.key(0))
    params = jload_params(str(path / "model.npz"), template)
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree_util.tree_leaves(params))
    import json
    with open(path / "metrics.json") as f:
        metrics = json.load(f)
    assert len(metrics["meta_loss"]) == 2
    assert all(np.isfinite(v) for v in metrics["adapt_reward"])
