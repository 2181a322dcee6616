"""Offline RL evaluation of a run directory on device envs (port of the
device-env branch of ``exploring_meta_tpu/analysis/eval_rl.py``;
reference ``misc_scripts/eval_rl.py``): reload a trained policy from a run
directory (model.npz, or ``model_checkpoints/model_<N>.npz`` with
``checkpoint``), then run the meta-test evaluation and optionally the CL
and representation-change experiments on fresh tasks, and the CCA of
consecutive checkpoints on the real states of one probe rollout ->
``eval_results.json``, ``cl_exp/``, ``rep_exp/``,
``cca_through_time.json``.

``test_on_train`` builds the env with ``test=False`` as in JAX
(Particles2D has no train/test split of its goals). Host envs (MuJoCo,
Meta-World) and their switches (``task_batch``, ``workers``, ML10 tables
and plots) are not ported yet. It runs on the card unless
``device="cpu"``. Each section is a module-level function that
:func:`run` looks up when it calls it.
"""

from __future__ import annotations

import json
import os

import torch

from exploring_meta_tpu_torch.analysis.cl import run_cl_rl_exp
from exploring_meta_tpu_torch.analysis.rc import (
    measure_change_through_time, real_states, run_rep_rl_exp,
)
from exploring_meta_tpu_torch.device import resolve_device
from exploring_meta_tpu_torch.envs.factory import HOST_ENVS, make_env
from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig
from exploring_meta_tpu_torch.rl.evaluate import evaluate
from exploring_meta_tpu_torch.rl.rollout import make_rollout
from exploring_meta_tpu_torch.trainers.rl import build_policy
from exploring_meta_tpu_torch.utils.experiment import (
    list_checkpoints, load_params,
)


def _checkpoint_path(base_path: str, checkpoint: int | None) -> str:
    """model.npz, or model_checkpoints/model_<N>.npz when a checkpoint
    number is chosen (reference eval_rl.py:126-139)."""
    if checkpoint is None:
        return os.path.join(base_path, "model.npz")
    return os.path.join(base_path, "model_checkpoints",
                        f"model_{checkpoint}.npz")


def run(base_path: str, run_eval: bool = True, run_cl: bool = False,
        run_rc: bool = False, n_eval_tasks: int | str | None = None,
        each3: bool = False, test_on_train: bool = False,
        checkpoint: int | None = None, workers: int | None = None,
        task_batch: bool = False, device=None) -> dict:
    """Evaluate a run directory. ``n_eval_tasks`` (default: the config's,
    else 10) is a task count; a task name, like ``each3``, raises
    ``ValueError`` on a device env, as in JAX."""
    if task_batch or workers is not None:
        raise NotImplementedError(f"eval_rl: task_batch / workers: "
                                  f"{HOST_ENVS}")
    dev = resolve_device(device)
    with open(os.path.join(base_path, "logger.json")) as f:
        config = json.load(f)["config"]
    anil = config["algo"].startswith("anil")
    algo = config["algo"].split("_")[-1]
    seed = config["seed"]
    cfg = RLConfig(
        inner_lr=config["inner_lr"], gamma=config["gamma"],
        tau=config["tau"], adapt_steps=config["adapt_steps"],
        adapt_batch_size=config["adapt_batch_size"],
        max_path_length=config["max_path_length"],
        ppo_epochs=config.get("ppo_epochs", 3),
        ppo_clip_ratio=config.get("ppo_clip_ratio", 0.3), anil=anil)

    # meta-test env: the test split unless test_on_train (reference
    # rl.py:153)
    env, is_device = make_env(config["dataset"],
                              workers=cfg.adapt_batch_size, seed=seed,
                              test=not test_on_train,
                              max_path_length=cfg.max_path_length)
    policy = build_policy(env, anil, fc_neurons=config.get("fc_neurons", 100),
                          activation=config.get("activation", "relu"))
    template = policy.init(torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    params = load_params(_checkpoint_path(base_path, checkpoint), template)
    roll = make_rollout(env, policy.sample, episodes=cfg.adapt_batch_size,
                        horizon=cfg.max_path_length)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    out = {}
    if run_eval:
        n_tasks = (n_eval_tasks if n_eval_tasks is not None
                   else config.get("n_eval_tasks", 10))
        out["eval"] = evaluate(algo, policy, params, env, roll, cfg, n_tasks,
                               gen, device_env=is_device, each3=each3,
                               test_on_train=test_on_train)
        print("Final evaluation:", out["eval"]["mean_reward"],
              "success:", out["eval"]["mean_success"])
    if run_cl:
        _, out["cl_res_rew"], out["cl_res_suc"] = run_cl_rl_exp(
            base_path, policy, params, env, roll, cfg, gen, algo=algo)
    if run_rc:
        out["rep_res"] = run_rep_rl_exp(base_path, policy, params, env, roll,
                                        cfg, gen, algo=algo)
        # representation drift across training checkpoints (reference
        # rc_rl.py:295-353) on the real states of one probe rollout
        ckpt_paths = [path for _, path in list_checkpoints(base_path)]
        if len(ckpt_paths) >= 2:
            probe_task = env.sample_tasks(gen, 1)[0]
            probe = real_states(roll(params, probe_task, gen))[:64]
            out["cca_through_time"] = measure_change_through_time(
                base_path, [load_params(p, template) for p in ckpt_paths],
                policy.get_representation, probe)

    with open(os.path.join(base_path, "eval_results.json"), "w") as f:
        json.dump(out, f, sort_keys=True, indent=4, default=str)
    return out
