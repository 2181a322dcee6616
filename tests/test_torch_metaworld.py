"""Meta-World in the port, on the repo's fake ``metaworld`` package
(``tests/fake_metaworld.py``, the JAX package's own ML10 fixture): the
adapter and the factory against JAX's, fake-ML10 collection bit for bit,
the ML10 task selections (``each3``, a named task) picking JAX's tasks,
a task-batched PPO iteration on JAX's collected replays, and ``eval_rl``
on an ML10 run dir (the per-task JSON, the bar plots, CL one task per id
and RC on every task, grouped and per task)."""

import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from exploring_meta_tpu.envs import factory as jfactory
from exploring_meta_tpu.envs import host as jhost
from exploring_meta_tpu.envs import metaworld_adapter as jadapter
from exploring_meta_tpu.models.policies import DiagNormalPolicy as JPolicy
from exploring_meta_tpu.rl import adapt_rl as jrl
from exploring_meta_tpu.rl import host_batched as jhb
from exploring_meta_tpu.rl import replay_meta as jreplay
from exploring_meta_tpu_torch.adapt.maml import adam
from exploring_meta_tpu_torch.analysis import eval_rl
from exploring_meta_tpu_torch.envs import factory
from exploring_meta_tpu_torch.envs import host
from exploring_meta_tpu_torch.envs import metaworld_adapter as adapter
from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
from exploring_meta_tpu_torch.rl import evaluate
from exploring_meta_tpu_torch.rl import host_batched as hb
from exploring_meta_tpu_torch.rl.rollout import Trajectory
from exploring_meta_tpu_torch.trainers.rl import RLTrainer, rl_config
from exploring_meta_tpu_torch.utils.bridge import params_from_jax
from exploring_meta_tpu_torch.utils.config import RLScriptConfig
from exploring_meta_tpu_torch.utils.tree import tree_items, tree_map

# the JAX package's rl/__init__ exports its evaluate() under the module's name
jevaluate = importlib.import_module("exploring_meta_tpu.rl.evaluate")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these small runs only lose to the contention
    of several test workers' thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_adapter_and_factory_equal_jax_s(fake_metaworld):
    """The same task draws, slot seeds, horizon-done and clamping as JAX's
    adapter; ML1 / ML10 / ML45 routed alike; no metaworld is imported
    until a benchmark is built."""
    for split in (False, True):
        ours = adapter.MetaWorldEnv("ML10", seed=3, test=split,
                                    max_path_length=4)
        theirs = jadapter.MetaWorldEnv("ML10", seed=3, test=split,
                                       max_path_length=4)
        a, b = ours.sample_tasks(None, 30), theirs.sample_tasks(None, 30)
        assert [t["task"] for t in a] == [t["task"] for t in b]
        assert [t["mw_task"].env_name for t in a] == \
            [t["mw_task"].env_name for t in b]
        names = (evaluate.ML10_EVAL_TASK_NAMES if split
                 else evaluate.ML10_TRAIN_TASK_NAMES)
        assert all(t["mw_task"].env_name == names[t["task"]] for t in a)
        ours.set_task(a[0])
        theirs.set_task(b[0])
        np.testing.assert_array_equal(ours.reset(seed=1), theirs.reset(seed=1))
        for t in range(4):
            x, y = ours.step(np.full(4, 5.0)), theirs.step(np.full(4, 5.0))
            np.testing.assert_array_equal(x[0], y[0])
            assert x[1:] == y[1:] and x[2] == (t == 3)
        assert np.abs(ours._env.last_action).max() <= 1.0
    assert evaluate.ML10_TRAIN_TASK_NAMES == jevaluate.ML10_TRAIN_TASK_NAMES
    assert evaluate.ML10_EVAL_TASK_NAMES == jevaluate.ML10_EVAL_TASK_NAMES
    for name in ("ML1_push", "ML10", "ML45"):
        env, dev = factory.make_env(name, workers=3, seed=2)
        jenv, jdev = jfactory.make_env(name, workers=3, seed=2)
        assert dev is jdev is False and env.n_envs == 3
        assert [type(e._bench).__name__ for e in env.envs] == \
            [type(e._bench).__name__ for e in jenv.envs]
        assert len({id(e._bench) for e in env.envs}) == 1  # one benchmark
    assert factory.calculate_samples_seen(100, 20, 1, 20, 3) == \
        jfactory.calculate_samples_seen(100, 20, 1, 20, 3)


@pytest.mark.parametrize("backend", ["python", "native"])
def test_fake_ml10_collection_equals_jax(fake_metaworld, backend):
    """Three slots of fake ML10 under one action table (beyond the action
    space too): the port's collection equals JAX's bit for bit, and the
    pool's equals the loop's."""
    table = np.random.default_rng(0).uniform(-2, 2, (15, 3, 4)).astype(
        np.float32)
    got = {}
    for name, make in (("ours", factory.make_env),
                       ("theirs", jfactory.make_env)):
        for b in (backend, "python"):
            vec, _ = make("ML10", workers=3, seed=4, max_path_length=10,
                          backend=b, n_threads=2)
            vec.set_task(vec.sample_tasks(None, 1)[0])
            steps = iter(range(15))
            key = torch.Generator() if name == "ours" else jax.random.key(0)
            got[name, b] = [np.asarray(x) for x in vec.collect(
                lambda k, o: table[next(steps)], key, 15, seed=2)]
            assert vec.backend == b
    for a, b in zip(got["ours", backend], got["theirs", backend]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got["ours", backend], got["ours", "python"]):
        np.testing.assert_array_equal(a, b)
    done = got["ours", backend][3]
    assert (done[9] == 1).all()  # the adapter's horizon, 10 < 15


def test_task_selection_picks_jax_s_tasks(fake_metaworld):
    env, _ = factory.make_env("ML10", workers=1, seed=7, test=True)
    jenv, _ = jfactory.make_env("ML10", workers=1, seed=7, test=True)
    for per_task in (3, 1):
        ours = evaluate.sample_3_from_each_task(env, None, per_task=per_task)
        theirs = jevaluate.sample_3_from_each_task(jenv, None,
                                                   per_task=per_task)
        assert [(t["task"], t["mw_task"].data.tolist()) for t in ours] == \
            [(t["task"], t["mw_task"].data.tolist()) for t in theirs]
        assert [t["task"] for t in ours] == sorted(
            i for i in range(5) for _ in range(per_task))
    for name in ("door-close", "reach", "lever-pull"):
        ours = evaluate.sample_explicit_task(env, None, name)
        theirs = jevaluate.sample_explicit_task(jenv, None, name)
        if theirs is None:
            assert ours is None
        else:
            assert ours["task"] == theirs["task"]
            assert ours["mw_task"].data.tolist() == \
                theirs["mw_task"].data.tolist()


def test_task_batched_ppo_iteration_on_jax_replays(fake_metaworld,
                                                   tmp_path):
    """JAX's ``collect_task_batched`` on fake ML10 (3 tasks x 2 episodes x
    8 steps, 2 PPO epochs) fed to the port's: the adapted params within
    1e-5 of max|params|; the trainer's ``--task_batch`` iteration on the
    same replays: the meta-loss within 1e-5 of its terms' scale, one Adam
    step within 1e-5 of lr of optax's."""
    cfg = RLScriptConfig(env="ML10", meta_batch_size=3, adapt_batch_size=2,
                         max_path_length=8, outer_lr=0.01, task_batch=True,
                         ppo_epochs=2)
    rl_cfg = rl_config(cfg)
    jcfg = jrl.RLConfig(**rl_cfg._asdict())
    jpolicy = JPolicy(input_size=9, output_size=4, hiddens=(32, 32))
    jparams = jpolicy.init(jax.random.key(0))
    big, _ = jfactory.make_env("ML10", workers=6, seed=1, max_path_length=8)
    tasks = big.sample_tasks(None, 3)
    grouped = jhost.make_grouped_host_rollout(big, jpolicy, 8, 3, 2)
    store = []

    def recording(p, t, k):
        traj = grouped(p, t, k)
        store.append(traj)
        return traj

    jold, jreplays, jm = jhb.collect_task_batched(
        "ppo", jpolicy, jparams, recording, tasks, jax.random.key(1), jcfg)
    meta_loss = jreplay.make_replay_meta_loss("ppo", jpolicy, jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(meta_loss))(jparams, jreplays)
    opt = optax.adam(0.01)
    updates, _ = opt.update(jgrads, opt.init(jparams), jparams)
    jnew = optax.apply_updates(jparams, updates)

    def feeder():
        fed = iter(store)
        return lambda p, t, g: Trajectory(
            *(torch.as_tensor(np.array(x)) for x in next(fed)))

    policy = DiagNormalPolicy(9, 4, hiddens=(32, 32))
    params = params_from_jax(jparams, "cpu")
    old, replays, m = hb.collect_task_batched("ppo", policy, params,
                                              feeder(), tasks,
                                              torch.Generator(), rl_cfg)
    top = max(float(np.abs(np.asarray(x)).max())
              for x in jax.tree_util.tree_leaves(jold))
    for key, leaf in tree_items(old):
        want = np.asarray(dict(tree_items(params_from_jax(jold, "cpu")))[key])
        assert np.abs(leaf.numpy() - want).max() <= 1e-5 * top, key
    assert float(m["reward"]) == pytest.approx(float(jm["reward"]), rel=1e-6)

    class Tasks:
        def sample_tasks(self, gen, n):
            return tasks

    trainer = RLTrainer(cfg, algo="ppo", device="cpu",
                        path=str(tmp_path) + "/")
    step = trainer._make_host_batched_iteration(Tasks(), policy, feeder(),
                                                rl_cfg)
    params = tree_map(torch.Tensor.requires_grad_, params)
    _, _, metrics = step(params, adam(params, 0.01), torch.Generator())
    assert abs(float(metrics["meta_loss"]) - float(jloss)) <= 1e-5
    # as test_torch_rl_replay.py holds one Adam step: the meta-gradient
    # within 1e-4 of each leaf's max|g|; the step within 1e-5 of lr of
    # optax's on the port's own gradient (optax's float32 bias correction
    # moves it ~6.4e-6 lr), and of JAX's whole step where |g| is resolved
    # far beyond the gradient's tolerance (a first Adam step is about
    # lr x sign(g))
    got = {k: leaf.detach().numpy() for k, leaf in tree_items(params)}
    grads = {k: leaf.grad.numpy() for k, leaf in tree_items(params)}
    jg = {k: np.asarray(v) for k, v in tree_items(jgrads)}
    for key, g in grads.items():
        assert np.abs(g - jg[key]).max() <= 1e-4 * np.abs(jg[key]).max(), key
    own, _ = opt.update(jax.tree_util.tree_map(jnp.asarray, tree_map(
        lambda t: t.grad.numpy(), params)), opt.init(jparams), jparams)
    own = dict(tree_items(optax.apply_updates(jparams, own)))
    want = dict(tree_items(jnew))
    for key, w in got.items():
        np.testing.assert_allclose(w, np.asarray(own[key]), rtol=0,
                                   atol=1e-5 * 0.01)
        big = np.abs(jg[key]) > 1e-2 * np.abs(jg[key]).max()
        np.testing.assert_allclose(w[big], np.asarray(want[key])[big],
                                   rtol=0, atol=1e-5 * 0.01)


def _ml10_run(tmp_path, **change):
    cfg = RLScriptConfig(**{"env": "ML10", "num_iterations": 1,
                            "meta_batch_size": 2, "adapt_batch_size": 2,
                            "max_path_length": 6, "n_eval_tasks": 2,
                            "outer_lr": 0.01, **change})
    trainer = RLTrainer(cfg, algo="ppo", device="cpu",
                        path=str(tmp_path) + "/")
    trainer.run()
    return trainer.model_path


def test_eval_rl_writes_the_per_task_json_and_bars_as_jax(fake_metaworld,
                                                          tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """``eval_rl`` on a port-trained ML10 run dir (``--task_batch``
    trained): ``each3`` writes ``maml_ppo_test_42.json`` keyed by ML10's
    eval names (3 trials of each) and its bar plot, a named task its
    one-task plot, ``test_on_train`` the train table's names, as JAX's
    ``eval_rl.run`` does on the same run dir; without matplotlib each plot
    is one printed line."""
    from exploring_meta_tpu.analysis import eval_rl as jeval_rl
    run = _ml10_run(tmp_path, task_batch=True)
    out = eval_rl.run(run, each3=True, task_batch=True, device="cpu")
    with open(os.path.join(run, "maml_ppo_test_42.json")) as f:
        ours = json.load(f)
    jout = jeval_rl.run(run, each3=True, task_batch=True)
    with open(os.path.join(run, "maml_ppo_test_42.json")) as f:
        theirs = json.load(f)
    assert set(ours) == set(theirs) == set(
        evaluate.ML10_EVAL_TASK_NAMES.values())
    assert all(len(v) == 6 for v in ours.values())
    assert ours == out["eval"]["rewards_per_task"]
    assert set(out["eval"]) == set(jout["eval"])
    assert os.path.exists(os.path.join(run, "maml_ppo_test_42.png"))
    out = eval_rl.run(run, n_eval_tasks="door-close", device="cpu")
    assert list(out["eval"]["rewards_per_task"]) == ["door-close"]
    assert os.path.exists(os.path.join(run, "maml_ppo_test_42_door-close"
                                            ".png"))
    out = eval_rl.run(run, n_eval_tasks=3, test_on_train=True, workers=2,
                      device="cpu")
    assert set(out["eval"]["rewards_per_task"]) <= set(
        evaluate.ML10_TRAIN_TASK_NAMES.values())
    assert os.path.exists(os.path.join(run, "maml_ppo_train_42.json"))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    os.remove(os.path.join(run, "maml_ppo_test_42.png"))
    capsys.readouterr()
    eval_rl.run(run, n_eval_tasks="door-close", device="cpu")
    printed = capsys.readouterr().out
    for fn in ("bar_plot_ml10", "bar_plot_ml10_one_task"):
        assert printed.count(f"{fn}: matplotlib is not installed") == 1
    assert not os.path.exists(os.path.join(run, "maml_ppo_test_42.png"))


def test_cl_one_per_task_and_rc_each_task_grouped_equal_per_task(
        fake_metaworld, tmp_path):
    """CL over one task of each ML10 eval id and RC over 3 trials of each,
    per task and through the grouped factory (``--task_batch``): the same
    artifacts as JAX's (``adapt_progress.json`` per task and step, 5 x 5
    matrices, 15 probes a layer) and, under a policy that acts its mean
    (so that the two orders of the action noise do not enter), the same
    numbers up to float32 rounding."""
    from exploring_meta_tpu_torch.analysis.cl import run_cl_rl_exp
    from exploring_meta_tpu_torch.analysis.rc import run_rep_rl_exp

    class MeanPolicy(DiagNormalPolicy):
        def sample(self, params, gen, state):
            return self.density(params, state)[0]

    cfg = rl_config(RLScriptConfig(adapt_batch_size=2, max_path_length=6))
    policy = MeanPolicy(9, 4)
    params = policy.init(torch.Generator().manual_seed(0), device="cpu")
    res = {}
    for mode in ("per_task", "grouped"):
        env, _ = factory.make_env("ML10", workers=2, seed=3, test=True,
                                  max_path_length=6)
        roll = host.make_host_rollout(env, policy, 6)
        groups = (host.make_grouped_roll_factory("ML10", policy, cfg, 3)
                  if mode == "grouped" else None)
        path = str(tmp_path / mode)
        rew, _, _ = run_cl_rl_exp(path, policy, params, env, roll, cfg,
                                  torch.Generator(), algo="vpg",
                                  one_per_task=True,
                                  grouped_roll_factory=groups)
        rep = run_rep_rl_exp(path, policy, params, env, roll, cfg,
                             torch.Generator(), algo="vpg",
                             compare=("cca", "cka_linear"),
                             eval_each_task=True,
                             grouped_roll_factory=groups)
        with open(os.path.join(path, "cl_exp", "adapt_progress.json")) as f:
            progress = json.load(f)
        res[mode] = (rew, rep, progress)
        assert np.asarray(rew).shape == (5, 5)
        assert sorted(progress) == ["reward", "success"]
        assert sorted(progress["reward"]) == [f"task_{i}"
                                              for i in range(1, 6)]
        assert all(list(v) == ["step_0"] for v in progress["reward"].values())
        assert all(len(v) == 15 for v in rep["cca"].values())
        assert len(rep["across_steps"]["init_mean"]) == 15
    np.testing.assert_allclose(res["grouped"][0], res["per_task"][0],
                               rtol=1e-4, atol=1e-4)
    for layer, v in res["per_task"][1]["cka_linear"].items():
        np.testing.assert_allclose(res["grouped"][1]["cka_linear"][layer], v,
                                   rtol=1e-4, atol=1e-4)
    for k in ("reward", "success"):
        for task, steps in res["per_task"][2][k].items():
            assert res["grouped"][2][k][task]["step_0"] == pytest.approx(
                steps["step_0"], rel=1e-4, abs=1e-4)
