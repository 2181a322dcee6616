"""The non-meta baselines of the PyTorch port (plain PPO, TRPO, the random
policy, supervised vision) vs the JAX package's, on the CPU.

JAX's update functions are closures inside each trainer's ``run()``, so
both trainers run whole, one iteration at meta-batch 1 (vision: one
iteration of ``int(320 / meta_batch_size)`` Adam steps), patched at the
same seams on both sides (``monkeypatch``; nothing in the JAX package
changes): ``_setup_rl_baseline`` returns a policy whose ``init`` gives
fixed params and a rollout that returns a fixed trajectory (JAX's rollout
of that policy, as numpy); ``init_cnn4``, ``get_dataset`` and
``sample_task_batch`` return fixed params and images; ``meta_test`` is
stubbed. Then each side's ``model.npz`` is read back. Small size: E = 4
episodes, T = 12 steps, hiddens (32, 32); the CNN4 at full width.

Tolerances. Adam scales each element's step by its own gradient history,
so an element whose gradient is near zero turns a last-bit difference of
its gradient into a step difference of up to ~lr: JAX does not agree with
itself to 1e-5 of max|params| on these updates either (jitted vs eager,
direct vs Pallas convs; measured numbers at each test). Each test holds
what JAX's own spread allows and names it; TRPO the same accepted candidate
and 2e-2 of the step (ROADMAP Queue 3: float32 CG amplifies last-bit
differences).
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

import exploring_meta_tpu.models as jmodels
import exploring_meta_tpu.rl as jrl
import exploring_meta_tpu.tasks as jtasks
from exploring_meta_tpu.envs.particles2d import Particles2D as JEnv
from exploring_meta_tpu.models.cnn4 import omniglot_spec as jomniglot_spec
from exploring_meta_tpu.models.policies import DiagNormalPolicy as JPolicy
from exploring_meta_tpu.rl.rollout import rollout as jrollout
from exploring_meta_tpu.trainers import baselines as jb
from exploring_meta_tpu.utils import config as jconfig
from exploring_meta_tpu.utils.experiment import load_params as jload_params
from exploring_meta_tpu_torch import cli
from exploring_meta_tpu_torch.envs.particles2d import Particles2D
from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
from exploring_meta_tpu_torch.ops.value import linear_value_features
from exploring_meta_tpu_torch.rl.rollout import Trajectory
from exploring_meta_tpu_torch.trainers import baselines as tb
from exploring_meta_tpu_torch.trainers.rl import rl_config, trpo_config
from exploring_meta_tpu_torch.utils.bridge import params_from_jax
from exploring_meta_tpu_torch.utils.config import (
    RLScriptConfig, VisionConfig,
)
from exploring_meta_tpu_torch.utils.tree import tree_items

E, T = 4, 12
HIDDENS = (32, 32)
RL_SMALL = dict(num_iterations=1, meta_batch_size=1, adapt_batch_size=E,
                max_path_length=T, n_eval_tasks=2, save_every=1)
# vision: 64 tasks an iteration -> int(320 / 64) = 5 Adam steps
VISION_SMALL = dict(num_iterations=1, meta_batch_size=64, save_every=1,
                    synthetic=True)
STUB_EVAL = {"tasks_rewards": [0.0], "tasks_success_rate": [0.0],
             "mean_reward": -1.5, "mean_success": 0.0, "rewards_per_task": {}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the vision baseline trains the CNN4 at full
    width, which only loses to the contention of several test workers'
    thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Fixed:
    """A policy spec whose ``init`` returns fixed params; everything else
    is the wrapped spec's."""

    def __init__(self, policy, make_params):
        self._policy, self._make = policy, make_params

    def init(self, *args, **kwargs):
        return self._make()

    def __getattr__(self, name):
        return getattr(self._policy, name)


@pytest.fixture(scope="module")
def rl_data():
    """Perturbed JAX params (non-zero biases) and one JAX rollout of that
    policy around a goal it reaches within the horizon in some episodes
    (episodes of several lengths)."""
    jpol = JPolicy(2, 2, hiddens=HIDDENS)
    jparams = jax.tree_util.tree_map(
        lambda x: x + 0.05 * jax.random.normal(jax.random.key(7), x.shape),
        jpol.init(jax.random.key(0)))
    traj = jrollout(JEnv(), jpol.sample, jparams,
                    jnp.asarray([0.12, -0.08], jnp.float32),
                    jax.random.key(3), E, T)
    return jparams, jax.tree_util.tree_map(np.asarray, traj)


def _patch_rl(monkeypatch, jparams, jtraj):
    """Both packages' ``_setup_rl_baseline`` and ``meta_test`` patched."""
    def jsetup(cfg):
        roll = lambda params, task, key: jax.tree_util.tree_map(
            jnp.asarray, jtraj)
        return JEnv(), True, _Fixed(JPolicy(2, 2, hiddens=HIDDENS),
                                    lambda: jparams), roll

    def tsetup(cfg):
        traj = Trajectory(*(torch.as_tensor(np.array(x)).unsqueeze(0)
                            for x in jtraj))
        return Particles2D(), True, _Fixed(
            DiagNormalPolicy(2, 2, hiddens=HIDDENS),
            lambda: params_from_jax(jparams, "cpu")), \
            lambda params, task, gen: traj

    monkeypatch.setattr(jb, "_setup_rl_baseline", jsetup)
    monkeypatch.setattr(tb, "_setup_rl_baseline", tsetup)
    monkeypatch.setattr(jrl, "meta_test", lambda *a, **k: dict(STUB_EVAL))
    monkeypatch.setattr(tb, "meta_test", lambda *a, **k: dict(STUB_EVAL))


def _run(jcls, tcls, jcfg, tcfg, tmp_path):
    """Run both trainers -> (JAX trainer, port trainer, JAX result, port
    result)."""
    jt = jcls(jcfg, path=str(tmp_path / "jax") + "/")
    jout = jt.run()
    tt = tcls(tcfg, path=str(tmp_path / "port") + "/", device="cpu")
    tout = tt.run()
    return jt, tt, jout, tout


def _model(trainer, name="model.npz") -> dict:
    with np.load(os.path.join(trainer.model_path, name)) as z:
        return {k: z[k].astype(np.float64) for k in z.files}


def _flat(tree) -> dict:
    """A JAX params tree -> ``{slash/path: float64 array}``."""
    return {k: np.asarray(v, np.float64) for k, v in tree_items(tree)}


def _max_err(got: dict, want: dict, keys=None) -> float:
    """max |got - want| over ``keys`` (all), relative to max|want| over
    every leaf."""
    assert sorted(got) == sorted(want)
    top = max(np.abs(v).max() for v in want.values())
    return max(np.abs(got[k] - want[k]).max() for k in (keys or want)) / top


# PPO: one Adam step a task agrees to 1.2e-6 of max|params| (optax's float32
# bias correction, ROADMAP Queue 3); three (the default) to 5.1e-5: Adam
# scales each element's step by its own gradient history, so an element
# whose gradient is ~1e-4 of the largest carries the ~1e-5 relative error
# of the advantages (the ill-conditioned float32 baseline fit) into its
# second and third steps at lr x (its relative error). JAX's own jitted and
# eager runs of this update differ by 3.5e-5 of max|params|.
PPO_TOL = {1: 1e-5, 3: 1e-4}


@pytest.mark.parametrize("epochs", sorted(PPO_TOL))
def test_ppo_baseline_matches_jax(rl_data, monkeypatch, tmp_path, epochs):
    jparams, jtraj = rl_data
    _patch_rl(monkeypatch, jparams, jtraj)
    kw = dict(RL_SMALL, ppo_epochs=epochs)
    jt, tt, jout, tout = _run(jb.PPOBaseline, tb.PPOBaseline,
                              jconfig.RLScriptConfig(**kw),
                              RLScriptConfig(**kw), tmp_path)
    want, got = _model(jt), _model(tt)
    assert _max_err(got, want) <= PPO_TOL[epochs], _max_err(got, want)
    # each Adam step at outer_lr 0.1 moved every leaf by ~0.1
    assert min(np.abs(want[k] - v).max() for k, v in _flat(jparams).items()
               ) > 0.05
    ckpt = _model(tt, "model_checkpoints/model_1.npz")
    assert int(ckpt.pop("__iteration__")) == 1 and _max_err(ckpt, got) == 0
    for key in ("average_return", "loss"):
        # the loss is a mean of O(1) terms (normalized advantages) that
        # cancel to ~0.03, so it is held absolutely
        assert tt.metrics[key] == pytest.approx(jt.metrics[key], rel=1e-5,
                                                abs=1e-5)
    assert tt.metrics["test_reward"] == jt.metrics["test_reward"] == [-1.5]
    assert tout["mean_reward"] == jout["mean_reward"]


def _flat_vec(d: dict) -> np.ndarray:
    return np.concatenate([d[k].ravel() for k in sorted(d)])


@pytest.mark.parametrize("outer_lr", [0.1, 4.0])
def test_trpo_baseline_matches_jax(rl_data, monkeypatch, tmp_path, outer_lr):
    """outer_lr 0.1 (the default): the first candidate, a tenth of the
    natural step, is taken; 4.0: candidates past the trust region are
    rejected until a later one falls inside. The accepted index is read
    from the port's update and from JAX's step length."""
    jparams, jtraj = rl_data
    _patch_rl(monkeypatch, jparams, jtraj)
    kw = dict(RL_SMALL, outer_lr=outer_lr)
    jt, tt, _, _ = _run(jb.TRPOBaseline, tb.TRPOBaseline,
                        jconfig.RLScriptConfig(**kw), RLScriptConfig(**kw),
                        tmp_path)
    init = _flat_vec(_flat(jparams))
    want, got = _flat_vec(_model(jt)), _flat_vec(_model(tt))
    policy = DiagNormalPolicy(2, 2, hiddens=HIDDENS)
    traj = Trajectory(*(torch.as_tensor(np.array(x)).unsqueeze(0)
                        for x in jtraj))
    cfg = RLScriptConfig(**kw)
    new, _, info = tb.trpo_update(policy, params_from_jax(jparams, "cpu"),
                                  traj, rl_config(cfg), trpo_config(cfg))
    np.testing.assert_array_equal(_flat_vec(_flat(
        {k: v.numpy() for k, v in tree_items(new)})), got)
    index = info["index"]
    assert index >= 0 and (index == 0) == (outer_lr == 0.1)
    # JAX's step: 0.5^i outer_lr times the natural step, which the port's
    # accepted step gives to ~1e-2: the same i within a factor sqrt(2)
    natural = np.linalg.norm(got - init) / (0.5 ** index * outer_lr)
    jindex = np.log2(outer_lr * natural / np.linalg.norm(want - init))
    assert abs(jindex - index) < 0.5, (jindex, index)
    # float32 CG on a Fisher damped by 1e-5 amplifies last-bit
    # differences (ROADMAP Queue 3): held to 2e-2 of the step
    err = np.linalg.norm(got - want) / np.linalg.norm(want - init)
    assert err <= 2e-2, err
    assert jt.logger["test_reward"] == tt.logger["test_reward"] == -1.5
    assert "test_reward" not in tt.metrics and "test_reward" not in jt.metrics


# The linear baseline's ridge matrix on this rollout has condition ~5e6,
# so its float32 weights move by ~1e-5 of their max with the summation
# order: JAX's own jitted and eager fits differ by 1.4e-5, the port's from
# JAX's by 4.3e-5. The values it predicts, which are what the advantages
# see, agree to 1.7e-6 of their max.
FIT_W_TOL, FIT_VALUE_TOL = 1e-4, 1e-5


def test_random_baseline_matches_jax(rl_data, monkeypatch, tmp_path):
    """The untrained policy's params are saved as they are; the baseline
    fitted on the rollout's discounted returns (the discount sweep)."""
    jparams, jtraj = rl_data
    _patch_rl(monkeypatch, jparams, jtraj)
    jt, tt, _, _ = _run(jb.RandomPolicyBaseline, tb.RandomPolicyBaseline,
                        jconfig.RLScriptConfig(**RL_SMALL),
                        RLScriptConfig(**RL_SMALL), tmp_path)
    assert _max_err(_model(tt), _model(jt)) == 0.0
    feats = linear_value_features(
        torch.as_tensor(jtraj.state.reshape(-1, 2), dtype=torch.float64),
        torch.as_tensor(jtraj.timestep.reshape(-1)))
    for name in ("baseline.npz", "model_checkpoints/baseline_1.npz"):
        want, got = _model(jt, name), _model(tt, name)
        assert list(got) == ["weight"] and got["weight"].shape == (8, 1)
        assert _max_err(got, want) <= FIT_W_TOL, _max_err(got, want)
        values = [(feats @ torch.as_tensor(w["weight"])).numpy()
                  for w in (got, want)]
        err = np.abs(values[0] - values[1]).max() / np.abs(values[1]).max()
        assert err <= FIT_VALUE_TOL, err
    assert tt.metrics["average_return"] == pytest.approx(
        jt.metrics["average_return"], rel=1e-6)
    assert tt.metrics["test_reward"] == jt.metrics["test_reward"] == [-1.5]


def _vision_data(n: int):
    """Fixed 5-way 1-shot task batches of ``n`` tasks: images in [0, 1],
    class-major labels."""
    rng = np.random.default_rng(n)
    data = rng.uniform(0, 1, (n, 10, 28, 28, 1)).astype(np.float32)
    return data, np.tile(np.repeat(np.arange(5), 2), (n, 1)).astype(np.int32)


@pytest.fixture(scope="module")
def vision_params():
    return jax.tree_util.tree_map(
        np.asarray, jmodels.init_cnn4(jax.random.key(5), jomniglot_spec(5)))


def _patch_vision(monkeypatch, jparams):
    monkeypatch.setattr(jmodels, "init_cnn4", lambda key, spec: jax.tree_util
                        .tree_map(jnp.asarray, jparams))
    monkeypatch.setattr(jtasks, "get_dataset", lambda *a, **k: (0, 1, 2))
    monkeypatch.setattr(jtasks, "sample_task_batch",
                        lambda key, ds, ways, shots, n: tuple(
                            map(jnp.asarray, _vision_data(n))))
    monkeypatch.setattr(tb, "init_cnn4", lambda gen, spec, device=None:
                        params_from_jax(jparams, "cpu"))
    monkeypatch.setattr(tb, "get_dataset", lambda *a, **k: (0, 1, 2))
    monkeypatch.setattr(tb, "sample_task_batch",
                        lambda gen, ds, ways, shots, n: tuple(
                            map(torch.as_tensor, _vision_data(n))))


# Vision: after five Adam steps JAX's own two conv lowerings (direct and
# Pallas) differ by 1.07e-4 of max|params|, the port's fused path from JAX's
# direct one by 4.8e-5. The conv biases are another matter: batch-stat BN
# removes them, so their gradient is rounding noise and Adam steps them by
# up to ~lr a step on its sign, in JAX too (jitted vs eager: 0.026 apart).
VISION_TOL = 1e-4


def test_vision_baseline_matches_jax(vision_params, monkeypatch, tmp_path):
    """Five Adam steps at outer_lr 0.003, JAX on its per-op convs, the port
    on the fused CNN4 twins (the kernels' CPU path)."""
    _patch_vision(monkeypatch, vision_params)
    jt, tt, jacc, tacc = _run(jb.VisionBaseline, tb.VisionBaseline,
                              jconfig.VisionConfig(**VISION_SMALL),
                              VisionConfig(**VISION_SMALL), tmp_path)
    want, got = _model(jt), _model(tt)
    conv_b = [k for k in want if k.endswith("conv/b")]
    err = _max_err(got, want, [k for k in want if k not in conv_b])
    assert err <= VISION_TOL, err
    steps, lr = 5, VisionConfig().outer_lr
    init = _flat(vision_params)
    for k in conv_b:     # each side moved its biases by at most ~lr a step
        assert np.abs(got[k] - init[k]).max() <= 1.5 * steps * lr
        assert np.abs(want[k] - init[k]).max() <= 1.5 * steps * lr
    assert tt.metrics["train_loss"] == pytest.approx(
        jt.metrics["train_loss"], rel=1e-5)
    assert tt.metrics["train_acc"] == jt.metrics["train_acc"]
    # the mean of 64 per-task accuracies in float32, summed in two orders
    assert tacc == pytest.approx(jacc, rel=1e-6)
    assert tt.logger["test_acc"] == tacc and "test_acc" not in tt.metrics


def _run_dir(path):
    (run,) = os.listdir(path)
    return os.path.join(path, run)


@pytest.mark.parametrize("command,prefix,root", [
    ("ppo_baseline", "ppo_Particles2D-v1_", "ppo_results"),
    ("trpo_baseline", "trpo_Particles2D-v1_", "trpo_results"),
    ("random_baseline", "random_Particles2D-v1_", "random_results"),
    ("vision_baseline", "baseline_omni_", "results"),
])
def test_cli_runs_on_the_cpu_only_when_asked(tmp_path, monkeypatch, command,
                                             prefix, root):
    """Each baseline from argv with ``EMT_FORCE_CPU=1`` (raising without it
    when there is no card, before a run dir is made): JAX's run-dir layout
    and metric keys, and its ``model.npz`` loads in the JAX package."""
    monkeypatch.chdir(tmp_path)
    vision = command == "vision_baseline"
    argv = (["--num_iterations", "2", "--meta_batch_size", "160",
             "--synthetic", "--save_every", "1"] if vision else
            ["--num_iterations", "2", "--meta_batch_size", "2",
             "--adapt_batch_size", "3", "--max_path_length", "8",
             "--n_eval_tasks", "2", "--save_every", "1"])
    monkeypatch.delenv("EMT_FORCE_CPU", raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.COMMANDS[command](argv)
        assert os.listdir(tmp_path) == []
    monkeypatch.setenv("EMT_FORCE_CPU", "1")
    out = cli.COMMANDS[command](argv)
    run = _run_dir(str(tmp_path / root))
    assert os.path.basename(run).startswith(prefix)
    with open(os.path.join(run, "metrics.json")) as f:
        metrics = json.load(f)
    with open(os.path.join(run, "logger.json")) as f:
        logger = json.load(f)
    ckpts = sorted(os.listdir(os.path.join(run, "model_checkpoints")))
    if vision:
        assert 0.0 <= out <= 1.0 and logger["test_acc"] == out
        assert set(metrics) == {"train_loss", "train_acc"}
        assert ckpts == ["model_0.npz", "model_1.npz"]
        assert logger["config"]["outer_lr"] == 0.001     # the script's
        template = jmodels.init_cnn4(jax.random.key(0), jomniglot_spec(5))
    else:
        assert math.isfinite(out["mean_reward"])
        assert logger["test_reward"] == out["mean_reward"]
        keys = {"ppo_baseline": {"average_return", "loss", "test_reward"},
                "trpo_baseline": {"average_return"},
                "random_baseline": {"average_return", "test_reward"}}
        assert set(metrics) == keys[command]
        want = ["model_1.npz", "model_2.npz"]
        if command == "random_baseline":
            want = ["baseline_1.npz", "baseline_2.npz"] + want
            with np.load(os.path.join(run, "baseline.npz")) as z:
                assert z["weight"].shape == (8, 1)
        assert ckpts == want
        template = JPolicy(2, 2).init(jax.random.key(0))
    assert all(len(v) == 2 for k, v in metrics.items() if k != "test_reward")
    assert all(v is not None and math.isfinite(v)
               for vals in metrics.values() for v in vals)
    assert {"config", "date", "model_id", "elapsed_time"} <= set(logger)
    params = jload_params(os.path.join(run, "model.npz"), template)
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree_util.tree_leaves(params))


def test_unsupported_flags_print_jax_s_note(capsys):
    for cfg, jcfg in ((RLScriptConfig(bf16=True, fuse=3, host_policy="cpu"),
                       jconfig.RLScriptConfig(bf16=True, fuse=3,
                                              host_policy="cpu")),
                      (VisionConfig(mesh=2, resume="x"),
                       jconfig.VisionConfig(mesh=2, resume="x")),
                      (RLScriptConfig(), jconfig.RLScriptConfig())):
        tb._warn_unsupported(cfg)
        ours = capsys.readouterr().out
        jb._warn_unsupported(jcfg)
        assert ours == capsys.readouterr().out
    assert tb._UNSUPPORTED == jb._UNSUPPORTED
    assert ours == ""


@pytest.mark.parametrize("cls", [tb.PPOBaseline, tb.TRPOBaseline,
                                 tb.RandomPolicyBaseline])
def test_host_envs_and_run_utilities_raise(tmp_path, monkeypatch,
                                           fake_metaworld, cls):
    """The host envs run (since slice 13): one tiny iteration of each RL
    baseline on AntDirection (real MuJoCo) and ML10 (the fake Meta-World
    package), through the per-task host rollout with the policy on the
    device, as JAX's baselines set it. The run utilities that JAX's
    baselines honour are accepted since slice 11
    (``test_run_utilities_are_accepted``)."""
    from exploring_meta_tpu_torch.envs import host
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(host, "_POLICY_DEVICE_MODE", "cpu")
    # one intra-op thread: Ant's baseline fit (214 features) is large
    # enough for the CPU build's multi-threaded solve, which has been seen
    # to hang after another test set the thread count
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for env in ("AntDirection-v1", "ML10"):
            cfg = RLScriptConfig(env=env, num_iterations=1,
                                 meta_batch_size=1, adapt_batch_size=2,
                                 max_path_length=4, n_eval_tasks=1,
                                 save_every=1)
            trainer = cls(cfg, path=str(tmp_path) + "/", device="cpu")
            final = trainer.run()
            assert np.isfinite(final["mean_reward"])
            assert os.path.exists(os.path.join(trainer.model_path,
                                               "model.npz"))
    finally:
        torch.set_num_threads(threads)
    assert host._POLICY_DEVICE_MODE == "device"
    env, is_device, _, roll = tb._setup_rl_baseline(RLScriptConfig(
        env="AntDirection-v1", adapt_batch_size=2))
    assert not is_device and env.n_envs == 2


@pytest.mark.parametrize("change", [{"use_wandb": True},
                                    {"compile_cache": "cache"}],
                         ids=["wandb", "compile_cache"])
@pytest.mark.parametrize("cls", [tb.PPOBaseline, tb.TRPOBaseline,
                                 tb.RandomPolicyBaseline, tb.VisionBaseline])
def test_run_utilities_are_accepted(tmp_path, monkeypatch, capsys, cls,
                                    change):
    """``--wandb`` (wandb is not installed: the run prints so and goes on,
    as JAX's does) and ``--compile_cache <dir>`` (the kernels' build
    directory moves there) construct each baseline and run one tiny
    iteration."""
    from exploring_meta_tpu_torch.cuda import build
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.setitem(sys.modules, "wandb", None)
    if cls is tb.VisionBaseline:
        cfg = VisionConfig(num_iterations=1, meta_batch_size=160,
                           synthetic=True, save_every=1, **change)
    else:
        cfg = RLScriptConfig(**{**RL_SMALL, "adapt_batch_size": 2,
                                "max_path_length": 5}, **change)
    trainer = cls(cfg, path=str(tmp_path / "runs") + "/", device="cpu")
    trainer.run()
    out = capsys.readouterr().out
    assert os.path.exists(os.path.join(trainer.model_path, "model.npz"))
    if "use_wandb" in change:
        assert "wandb unavailable" in out
    else:
        assert build.BUILD_DIR == str(tmp_path / "cache")
        assert os.path.isdir(tmp_path / "cache")


def test_setup_and_task_at():
    cfg = RLScriptConfig(adapt_batch_size=3, max_path_length=5)
    env, is_device, policy, roll = tb._setup_rl_baseline(cfg)
    assert is_device and policy == DiagNormalPolicy(2, 2)
    gen = torch.Generator().manual_seed(0)
    tasks = env.sample_tasks(gen, 4)
    one = tb._task_at(tasks, 2)
    assert one.shape == (1, 2) and torch.equal(one[0], tasks[2])
    traj = roll(policy.init(gen, device="cpu"), one, gen)
    assert traj.reward.shape == (1, 5, 3)
