"""The meta-RL trainer (MAML/ANIL x TRPO/PPO/VPG), config and CLI of the
PyTorch port, on the CPU.

The run directory must keep the JAX package's contract (its
``utils/experiment.py``): the same files, JSON keys and ``.npz`` key
names, so that the JAX package's ``load_params`` / ``load_checkpoint``
read the port's model and checkpoints. Small size: 3 tasks, 4 episodes,
12 steps.
"""

import dataclasses
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from exploring_meta_tpu.models.policies import DiagNormalPolicy as JPolicy
from exploring_meta_tpu.models.policies import DiagNormalPolicyANIL as JANIL
from exploring_meta_tpu.utils import config as jconfig
from exploring_meta_tpu.utils.experiment import load_checkpoint as jload_ckpt
from exploring_meta_tpu.utils.experiment import load_params as jload_params
from exploring_meta_tpu_torch import cli
from exploring_meta_tpu_torch.envs.particles2d import Particles2D
from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig
from exploring_meta_tpu_torch.rl.evaluate import evaluate, meta_test
from exploring_meta_tpu_torch.rl.rollout import make_rollout
from exploring_meta_tpu_torch.trainers.rl import RLTrainer
from exploring_meta_tpu_torch.utils.config import (
    RLScriptConfig, requested_device, rl_argparser,
)
from exploring_meta_tpu_torch.utils.experiment import (
    DivergenceError, Experiment, load_params,
)

SMALL = dict(meta_batch_size=3, adapt_batch_size=4, max_path_length=12,
             n_eval_tasks=2)
METRICS = {"adapt_reward", "adapt_success", "meta_loss", "ls_accepted",
           "eval_reward", "eval_success"}


def _template():
    return DiagNormalPolicy(2, 2).init(torch.Generator().manual_seed(0),
                                       device="cpu")


def _run_dir(path):
    (run,) = os.listdir(path)
    return os.path.join(path, run)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("runs")) + "/"
    cfg = RLScriptConfig(num_iterations=2, save_every=1, **SMALL)
    final = RLTrainer(cfg, algo="trpo", path=path, device="cpu").run()
    return final, _run_dir(path)


def test_run_dir_contract(trained):
    final, run = trained
    assert os.path.basename(run).startswith("maml_trpo_Particles2D-v1_")
    assert sorted(os.listdir(run)) == [
        "logger.json", "metrics.json", "model.npz", "model.summary",
        "model_checkpoints"]
    assert sorted(os.listdir(os.path.join(run, "model_checkpoints"))) == [
        "model_0.npz", "model_1.npz"]
    with open(os.path.join(run, "metrics.json")) as f:
        metrics = json.load(f)
    assert set(metrics) == METRICS
    assert all(len(metrics[k]) == 2 for k in METRICS - {"eval_reward",
                                                       "eval_success"})
    assert all(math.isfinite(v) for vals in metrics.values() for v in vals)
    with open(os.path.join(run, "logger.json")) as f:
        logger = json.load(f)
    assert {"config", "date", "model_id", "elapsed_time",
            "final_eval"} <= set(logger)
    assert logger["config"]["algo"] == "maml_trpo"
    assert logger["config"]["dataset"] == "Particles2D-v1"
    assert logger["final_eval"] == final
    assert len(final["tasks_rewards"]) == 2 and final["rewards_per_task"] == {}
    assert metrics["eval_reward"] == [final["mean_reward"]]


def test_jax_package_reads_the_ports_model_and_checkpoints(trained):
    _, run = trained
    import jax
    jtemplate = JPolicy(2, 2).init(jax.random.key(0))
    jparams = jload_params(os.path.join(run, "model.npz"), jtemplate)
    params = load_params(os.path.join(run, "model.npz"), _template())
    np.testing.assert_array_equal(np.asarray(jparams["mean"][1]["w"]),
                                  params["mean"][1]["w"].numpy())
    np.testing.assert_array_equal(np.asarray(jparams["sigma"]),
                                  params["sigma"].numpy())
    _, opt, rng, iteration = jload_ckpt(
        os.path.join(run, "model_checkpoints", "model_1.npz"), jtemplate)
    assert (opt, rng, iteration) == (None, None, 1)


def test_default_device_is_the_card_never_the_cpu(tmp_path):
    cfg = RLScriptConfig(num_iterations=1, **SMALL)
    if torch.cuda.is_available():
        assert RLTrainer(cfg, path=str(tmp_path) + "/").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RLTrainer(cfg, path=str(tmp_path) + "/")
        assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("change", [
    {"algo": "vpg", "env": "AntDirection-v1"},
    {"env": "AntDirection-v1"}, {"task_batch": True},
    {"mesh": 2},
])
def test_options_not_ported_raise(tmp_path, monkeypatch, change):
    """``--mesh`` raises before a run dir is made; the host envs and
    ``--task_batch`` (ignored on a device env, as in JAX) are ported and
    run one tiny iteration, AntDirection on real MuJoCo."""
    kw = {k: change.pop(k) for k in ("anil", "algo") if k in change}
    if "mesh" in change:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            RLTrainer(RLScriptConfig(**change), path=str(tmp_path) + "/",
                      device="cpu", **kw)
        assert os.listdir(tmp_path) == []
        return
    monkeypatch.chdir(tmp_path)
    cfg = RLScriptConfig(**change, num_iterations=1, meta_batch_size=2,
                         adapt_batch_size=2, max_path_length=5,
                         n_eval_tasks=1, outer_lr=0.01)
    trainer = RLTrainer(cfg, path=str(tmp_path) + "/", device="cpu", **kw)
    # one intra-op thread: Ant's baseline fit (214 features) is large
    # enough for the CPU build's multi-threaded solve, which has been seen
    # to hang after another test set the thread count
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        final = trainer.run()
    finally:
        torch.set_num_threads(threads)
    assert np.isfinite(final["mean_reward"])
    assert os.path.exists(os.path.join(trainer.model_path, "model.npz"))


@pytest.mark.parametrize("change", [
    {"resume": "model_checkpoints/model_0.npz"}, {"async_ckpt": True},
    {"ckpt_backend": "orbax"}, {"use_wandb": True}, {"profile": True},
    {"trace": "trace_dir"}, {"compile_cache": "cache"},
], ids=lambda c: next(iter(c)))
def test_run_utilities_run(tmp_path, monkeypatch, capsys, trained, change):
    """Each run utility constructs the trainer and runs a tiny MAML-TRPO
    run: the resume continues the ``trained`` run at iteration 1 and logs
    its row 1 exactly; an async checkpoint and a DCP step land; without
    wandb the run says so and goes on; ``--profile`` writes JAX's phases;
    ``--trace`` a Chrome trace; ``--compile_cache`` moves the kernels'
    build directory."""
    from exploring_meta_tpu_torch.cuda import build
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.setitem(sys.modules, "wandb", None)
    change = dict(change)
    if "resume" in change:
        change["resume"] = os.path.join(trained[1], change["resume"])
    cfg = RLScriptConfig(num_iterations=1 + ("resume" in change),
                         save_every=1, **SMALL, **change)
    trainer = RLTrainer(cfg, algo="trpo", path=str(tmp_path / "runs") + "/",
                        device="cpu")
    trainer.run()
    out = capsys.readouterr().out
    run = trainer.model_path
    with open(os.path.join(run, "metrics.json")) as f:
        metrics = json.load(f)
    assert len(metrics["meta_loss"]) == 1
    if "resume" in change:
        with open(os.path.join(trained[1], "metrics.json")) as f:
            full = json.load(f)
        assert all(metrics[k] == full[k][-1:] for k in METRICS)
    elif "async_ckpt" in change:
        with np.load(os.path.join(run, "model_checkpoints",
                                  "model_0.npz")) as z:
            assert int(z["__iteration__"]) == 0
    elif "ckpt_backend" in change:
        assert os.listdir(os.path.join(run, "model_checkpoints")) == ["0"]
    elif "use_wandb" in change:
        assert "wandb unavailable" in out
    elif "profile" in change:
        with open(os.path.join(run, "phase_times.json")) as f:
            phases = json.load(f)
        assert set(phases) == {"collect", "meta_step"}
        assert phases["collect"]["count"] == 1
    elif "trace" in change:
        (trace,) = os.listdir(tmp_path / "trace_dir")
        with open(tmp_path / "trace_dir" / trace) as f:
            assert "traceEvents" in json.load(f)
    else:
        assert build.BUILD_DIR == str(tmp_path / "cache")


class _Scripted(RLTrainer):
    """Iterations that report scripted losses, or are interrupted."""

    losses: list = []

    def _make_trpo_iteration(self, env, policy, roll, rl_cfg):
        losses = iter(self.losses)

        def iteration(params, _, gen):
            loss = next(losses)
            if loss is KeyboardInterrupt:
                raise KeyboardInterrupt
            return params, None, {"adapt_reward": -1.0, "adapt_success": 0.0,
                                  "meta_loss": loss, "ls_accepted": True}
        return iteration


@pytest.mark.parametrize("stop", ["diverged", "interrupted"])
def test_graceful_finish(tmp_path, stop):
    _Scripted.losses = [0.5, float("nan") if stop == "diverged"
                        else KeyboardInterrupt, 0.1]
    cfg = RLScriptConfig(num_iterations=3, **SMALL)
    trainer = _Scripted(cfg, path=str(tmp_path) + "/", device="cpu")
    final = trainer.run()
    run = _run_dir(str(tmp_path))
    with open(os.path.join(run, "logger.json")) as f:
        logger = json.load(f)
    with open(os.path.join(run, "metrics.json")) as f:
        metrics = json.load(f)
    assert logger["config"]["num_iterations"] == 1
    assert math.isfinite(final["mean_reward"])
    assert os.path.exists(os.path.join(run, "model.npz"))
    if stop == "diverged":
        assert "meta_loss = nan at logged step 1" in logger["diverged"]
        assert metrics["meta_loss"] == [0.5, None]     # strict JSON
    else:
        assert logger["manually_stopped"] is True
        assert metrics["meta_loss"] == [0.5]


def test_watchdog_only_watches_losses(tmp_path):
    exp = Experiment("maml_trpo", "Particles2D-v1", {"seed": 1},
                     path=str(tmp_path) + "/")
    exp.log_metrics({"adapt_reward": float("nan"), "ls_accepted": True})
    with pytest.raises(DivergenceError):
        exp.log_metrics({"meta_loss": float("inf")})
    exp.nan_guard = False
    exp.log_metrics({"meta_loss": float("nan")})
    assert exp.metrics["ls_accepted"] == [1.0]


def test_config_and_flags_match_the_jax_package():
    assert dataclasses.asdict(RLScriptConfig()) == dataclasses.asdict(
        jconfig.RLScriptConfig())
    ours = vars(rl_argparser(RLScriptConfig(), "port").parse_args([]))
    theirs = vars(jconfig.rl_argparser(jconfig.RLScriptConfig(),
                                       "jax").parse_args([]))
    assert ours == theirs
    argv = ["--num_iterations", "7", "--wandb", "--no_nan_guard",
            "--activation", "tanh", "--gamma", "0.9", "--bf16"]
    assert vars(rl_argparser(RLScriptConfig(), "p").parse_args(argv)) == vars(
        jconfig.rl_argparser(jconfig.RLScriptConfig(), "j").parse_args(argv))


def test_cli_runs_on_the_cpu_only_when_asked(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--num_iterations", "1", "--meta_batch_size", "2",
            "--adapt_batch_size", "3", "--max_path_length", "8",
            "--n_eval_tasks", "2"]
    monkeypatch.delenv("EMT_FORCE_CPU", raising=False)
    assert requested_device() is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.maml_trpo(argv)
    monkeypatch.setenv("EMT_FORCE_CPU", "1")
    assert requested_device() == "cpu"
    final = cli.maml_trpo(argv)
    assert math.isfinite(final["mean_reward"])
    (run,) = os.listdir(tmp_path / "results")
    assert run.startswith("maml_trpo_Particles2D-v1_")


def test_evaluate_device_env():
    env = Particles2D()
    policy = DiagNormalPolicy(2, 2, hiddens=(16, 16))
    gen = torch.Generator().manual_seed(0)
    params = policy.init(gen, device="cpu")
    cfg = RLConfig(inner_lr=0.05, adapt_batch_size=3, max_path_length=10)
    roll = make_rollout(env, policy.sample, 3, 10)
    out = evaluate("trpo", policy, params, env, roll, cfg, 4, gen)
    assert len(out["tasks_rewards"]) == 4
    assert out["mean_reward"] == pytest.approx(np.mean(out["tasks_rewards"]))
    assert all(-10.0 <= r < 0 for r in out["tasks_rewards"])
    assert 0.0 <= out["mean_success"] <= 1.0
    with pytest.raises(ValueError, match="sgd"):
        evaluate("sgd", policy, params, env, roll, cfg, 4, gen)
    for algo in ("ppo", "vpg"):
        out = evaluate(algo, policy, params, env, roll, cfg, 2, gen)
        assert all(-10.0 <= r < 0 for r in out["tasks_rewards"])
    # ML10 without metaworld (absent here, and on the card's machine)
    # raises the adapter's ImportError when the env is built, as in JAX
    with pytest.raises(ImportError, match="Meta-World is not installed"):
        meta_test("trpo", "ML10", policy, params, cfg, 4, gen)


@pytest.mark.parametrize("command", ["anil_trpo", "maml_ppo", "anil_ppo",
                                     "maml_vpg", "anil_vpg"])
def test_rl_cli_entries_run_on_the_cpu_only_when_asked(tmp_path, monkeypatch,
                                                       command):
    """One tiny iteration of each entry with ``EMT_FORCE_CPU=1``; its model
    and checkpoint load in the JAX package (the ANIL tree: ``body/...``,
    ``head/...``, ``sigma``)."""
    monkeypatch.chdir(tmp_path)
    argv = ["--num_iterations", "1", "--meta_batch_size", "2",
            "--adapt_batch_size", "3", "--max_path_length", "8",
            "--n_eval_tasks", "2", "--fc_neurons", "16"]
    monkeypatch.delenv("EMT_FORCE_CPU", raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.COMMANDS[command](argv)
        assert not os.path.exists(tmp_path / "results")
    monkeypatch.setenv("EMT_FORCE_CPU", "1")
    final = cli.COMMANDS[command](argv)
    assert math.isfinite(final["mean_reward"])
    run = _run_dir(str(tmp_path / "results"))
    assert os.path.basename(run).startswith(f"{command}_Particles2D-v1_")
    with open(os.path.join(run, "metrics.json")) as f:
        metrics = json.load(f)
    assert all(v is not None and math.isfinite(v)
               for vals in metrics.values() for v in vals)
    assert {"meta_loss", "adapt_reward", "adapt_success"} <= set(metrics)
    import jax
    jtemplate = (JANIL(2, 2, fc_neurons=16, hiddens=(100, 16))
                 if command.startswith("anil") else JPolicy(2, 2)).init(
                     jax.random.key(0))
    jparams = jload_params(os.path.join(run, "model.npz"), jtemplate)
    ckpt, _, _, iteration = jload_ckpt(
        os.path.join(run, "model_checkpoints", "model_0.npz"), jtemplate)
    assert iteration == 0
    for tree in (jparams, ckpt):
        assert all(np.isfinite(np.asarray(x)).all()
                   for x in jax.tree_util.tree_leaves(tree))
    if command.startswith("anil"):
        assert np.asarray(jparams["head"]["w"]).shape == (16, 2)
