"""Meta-RL trainer, MAML-TRPO on device envs (port of the device-env TRPO
path of ``exploring_meta_tpu/trainers/rl.py``; reference
``rl/maml_trpo.py``).

One iteration samples a meta-batch of tasks, collects each task's support
and query rollouts around a first-order inner step, then takes the
second-order TRPO outer step on the stored replays. After the last
iteration (or a KeyboardInterrupt, or a diverged loss) the trainer saves
the model and meta-tests it on fresh tasks.

Every option the JAX trainer has and the port does not run yet raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import time

import torch

from exploring_meta_tpu_torch.device import resolve_device
from exploring_meta_tpu_torch.envs.factory import make_env
from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig, make_trpo_collect
from exploring_meta_tpu_torch.rl.evaluate import meta_test
from exploring_meta_tpu_torch.rl.rollout import make_rollout
from exploring_meta_tpu_torch.rl.trpo_meta import (
    TRPOConfig, make_trpo_meta_step,
)
from exploring_meta_tpu_torch.utils.config import RLScriptConfig
from exploring_meta_tpu_torch.utils.experiment import (
    DivergenceError, Experiment,
)

_LATER = "is not ported yet (ROADMAP Queue 1, later slices: {})"


def _check_ported(cfg: RLScriptConfig, algo: str, anil: bool) -> None:
    unported = [
        (anil, "anil", "ANIL and the Adam outer paths"),
        (algo != "trpo", f"algo={algo!r}", "ANIL and the Adam outer paths"),
        (not cfg.env.startswith("Particles2D"), f"env={cfg.env!r}",
         "host envs"),
        (cfg.task_batch, "task_batch", "host envs"),
        (cfg.fuse > 1, "fuse > 1", "fused iterations and CUDA graphs"),
        (cfg.mesh > 1, "mesh > 1", "scale-out"),
        (cfg.bf16, "bf16", "bf16 RL"),
        (bool(cfg.resume), "resume", "run utilities"),
        (cfg.async_ckpt, "async_ckpt", "run utilities"),
        (cfg.ckpt_backend != "npz", "ckpt_backend='orbax'", "run utilities"),
        (cfg.use_wandb, "wandb", "run utilities"),
        (cfg.profile, "profile", "run utilities"),
        (bool(cfg.trace), "trace", "run utilities"),
        (bool(cfg.compile_cache), "compile_cache", "run utilities"),
    ]
    for hit, what, item in unported:
        if hit:
            raise NotImplementedError(f"RLTrainer: {what} " + _LATER.format(item))


class RLTrainer(Experiment):
    """MAML-TRPO meta-training loop for device envs.

    ``device`` defaults to the card; pass ``device="cpu"`` to train on the
    CPU. Without a card the default raises before any run dir is made."""

    def __init__(self, cfg: RLScriptConfig, algo: str = "trpo",
                 anil: bool = False, path: str = "results/", device=None):
        _check_ported(cfg, algo, anil)
        self.device = resolve_device(device)
        super().__init__(f"{'anil' if anil else 'maml'}_{algo}", cfg.env,
                         cfg.to_params(), path=path)
        self.cfg = cfg
        self.algo = algo

    def _trpo_cfg(self) -> TRPOConfig:
        cfg = self.cfg
        return TRPOConfig(outer_lr=cfg.outer_lr, max_kl=cfg.max_kl,
                          ls_max_steps=cfg.ls_max_steps,
                          backtrack_factor=cfg.backtrack_factor)

    def _make_trpo_iteration(self, env, policy, roll, rl_cfg: RLConfig):
        """``(params, None, gen) -> (params, None, metrics)``."""
        cfg = self.cfg
        meta_step = make_trpo_meta_step(policy, rl_cfg, self._trpo_cfg(),
                                        adapt_steps=cfg.adapt_steps)
        collect = make_trpo_collect(policy, roll, rl_cfg)

        def iteration(params, _, gen):
            tasks = env.sample_tasks(gen, cfg.meta_batch_size)
            old_params, _, replays, metrics = collect(params, tasks, gen)
            params, info = meta_step(params, old_params, replays)
            return params, None, {
                "adapt_reward": float(metrics["reward"].mean()),
                "adapt_success": float(metrics["success"].mean()),
                "meta_loss": float(info["old_loss"]),
                "ls_accepted": bool(info["accepted"]),
            }

        return iteration

    def run(self) -> dict:
        cfg = self.cfg
        env = make_env(cfg.env)
        policy = DiagNormalPolicy(env.obs_size, env.action_size,
                                  activation=cfg.activation)
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        params = policy.init(gen)
        self.log_model(params)
        rl_cfg = RLConfig(inner_lr=cfg.inner_lr, gamma=cfg.gamma,
                          tau=cfg.tau, adapt_steps=cfg.adapt_steps,
                          adapt_batch_size=cfg.adapt_batch_size,
                          max_path_length=cfg.max_path_length)
        roll = make_rollout(env, policy.sample,
                            episodes=cfg.adapt_batch_size,
                            horizon=cfg.max_path_length)
        step_fn = self._make_trpo_iteration(env, policy, roll, rl_cfg)

        start = time.perf_counter()
        iteration = 0
        try:
            for iteration in range(cfg.num_iterations):
                params, _, metrics = step_fn(params, None, gen)
                print(f"iteration {iteration}: {metrics}", flush=True)
                self.log_metrics(metrics)
                if iteration % cfg.save_every == 0:
                    self.save_model_checkpoint(params, iteration)
        except (KeyboardInterrupt, DivergenceError) as stop:
            self.mark_stopped(stop, iteration)

        self.save_model(params)
        self.logger["elapsed_time"] = (
            f"{round(time.perf_counter() - start, 2)} sec")

        final = meta_test(self.algo, cfg.env, policy, params, rl_cfg,
                          n_tasks=cfg.n_eval_tasks, gen=gen)
        print("Final evaluation:", final["mean_reward"],
              "success:", final["mean_success"])
        self.logger["final_eval"] = final
        self.log_metrics({"eval_reward": final["mean_reward"],
                          "eval_success": final["mean_success"]})
        self.save_logs_to_file()
        return final
