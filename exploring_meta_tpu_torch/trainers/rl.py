"""Meta-RL trainer on device envs: MAML/ANIL x TRPO/PPO/VPG (port of the
device-env paths of ``exploring_meta_tpu/trainers/rl.py``; reference
``rl/maml_trpo.py``, ``rl/anil_trpo.py``, ``rl/maml_ppo.py``,
``rl/anil_ppo.py``, ``rl/maml_vpg.py``).

One iteration samples a meta-batch of tasks. TRPO collects each task's
support and query rollouts around a first-order inner step, then takes
the second-order natural-gradient step on the stored replays. PPO and VPG
adapt every task to second order (a rollout keeps no graph: its actions
are data) and take one Adam step on the mean query loss. After the last
iteration (or a KeyboardInterrupt, or a diverged loss) the trainer saves
the model and meta-tests it on fresh tasks.

``--bf16`` runs every application of the policy's MLP in bfloat16 on
float32 master params (``models/policies.py``, ``compute_dtype``).

``--fuse N`` runs the iterations in chunks of N (``rl/train_scan.py``): on
the card one iteration is captured as a CUDA graph and replayed, the
metrics of a chunk come to the host in one copy, and checkpoints land on
chunk-end iterations (``trainers/fused.py``). Otherwise each iteration runs
eagerly and fetches its metrics in one copy.

The run utilities are JAX's: a checkpoint carries the params, the Adam
state and the generator, and ``--resume`` continues a run exactly where
it stopped (``utils/experiment.py``); ``--async_ckpt`` writes checkpoints
on a background thread, ``--ckpt_backend orbax`` as
``torch.distributed.checkpoint`` steps; ``--profile`` times JAX's phases
into ``phase_times.json`` and ``--trace`` records the training loop
(``utils/profiling.py``); ``--wandb`` logs the metrics rows.

Every option the JAX trainer has and the port does not run yet (host
envs, ``--mesh``) raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from exploring_meta_tpu_torch.adapt.maml import adam
from exploring_meta_tpu_torch.device import resolve_device
from exploring_meta_tpu_torch.envs.factory import make_env
from exploring_meta_tpu_torch.models.policies import (
    DiagNormalPolicy, DiagNormalPolicyANIL,
)
from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig
from exploring_meta_tpu_torch.rl.evaluate import meta_test
from exploring_meta_tpu_torch.rl.rollout import make_rollout
from exploring_meta_tpu_torch.rl.train_scan import (
    make_adam_iteration, make_adam_train_scan, make_trpo_iteration,
    make_trpo_train_scan,
)
from exploring_meta_tpu_torch.rl.trpo_meta import TRPOConfig
from exploring_meta_tpu_torch.trainers.fused import host_metrics, run_fused
from exploring_meta_tpu_torch.utils.config import (
    RLScriptConfig, raise_unported,
)
from exploring_meta_tpu_torch.utils.experiment import (
    DivergenceError, Experiment, resume_training,
)
from exploring_meta_tpu_torch.utils.profiling import (
    PhaseTimer, device_trace, no_phase,
)
from exploring_meta_tpu_torch.utils.tree import tree_map

ALGOS = ("trpo", "ppo", "vpg")


def build_policy(env, anil: bool, fc_neurons: int = 100,
                 activation: str = "relu"):
    """The policy of a run. ANIL's body is tanh by construction, with its
    output width tied to the head's input (``hiddens=(100, fc_neurons)``;
    the reference's body is [100, 100] whatever ``fc_neurons``);
    ``activation`` applies to ``DiagNormalPolicy`` only (the reference
    carries it but never passes it on)."""
    if anil:
        return DiagNormalPolicyANIL(env.obs_size, env.action_size,
                                    fc_neurons=fc_neurons,
                                    hiddens=(100, fc_neurons))
    return DiagNormalPolicy(env.obs_size, env.action_size,
                            activation=activation)


def rl_config(cfg: RLScriptConfig, anil: bool = False) -> RLConfig:
    """The fast-adapt hyperparameters of a run's script config."""
    return RLConfig(inner_lr=cfg.inner_lr, gamma=cfg.gamma, tau=cfg.tau,
                    adapt_steps=cfg.adapt_steps,
                    adapt_batch_size=cfg.adapt_batch_size,
                    max_path_length=cfg.max_path_length,
                    ppo_epochs=cfg.ppo_epochs,
                    ppo_clip_ratio=cfg.ppo_clip_ratio, anil=anil)


def trpo_config(cfg: RLScriptConfig) -> TRPOConfig:
    """The TRPO outer step's hyperparameters of a run's script config."""
    return TRPOConfig(outer_lr=cfg.outer_lr, max_kl=cfg.max_kl,
                      ls_max_steps=cfg.ls_max_steps,
                      backtrack_factor=cfg.backtrack_factor)


def _check_ported(cfg: RLScriptConfig) -> None:
    unported = [
        (not cfg.env.startswith("Particles2D"), f"env={cfg.env!r}",
         "host envs"),
        (cfg.task_batch, "task_batch", "host envs"),
        (cfg.mesh > 1, "mesh > 1", "scale-out"),
    ]
    raise_unported("RLTrainer", unported)


class RLTrainer(Experiment):
    """Meta-RL training loop for device envs; ``algo`` is ``"trpo"``,
    ``"ppo"`` or ``"vpg"``.

    ``device`` defaults to the card; pass ``device="cpu"`` to train on the
    CPU. Without a card the default raises before any run dir is made."""

    def __init__(self, cfg: RLScriptConfig, algo: str = "trpo",
                 anil: bool = False, path: str = "results/", device=None):
        if algo not in ALGOS:
            raise ValueError(f"unknown algo {algo!r} (one of {ALGOS})")
        _check_ported(cfg)
        self.device = resolve_device(device)
        super().__init__(f"{'anil' if anil else 'maml'}_{algo}", cfg.env,
                         cfg.to_params(), path=path,
                         use_wandb=cfg.use_wandb)
        self.cfg = cfg
        self.algo = algo
        self.anil = anil
        self._timer = PhaseTimer() if cfg.profile else None
        self.ckpt_backend = cfg.ckpt_backend

    def _ph(self, name: str):
        """A ``--profile`` phase (a no-op when profiling is off)."""
        return self._timer.phase(name) if self._timer else no_phase(name)

    def _make_trpo_iteration(self, env, policy, roll, rl_cfg: RLConfig):
        """``(params, None, gen) -> (params, None, metrics)``; the line
        search stops at the first accepted candidate."""
        iteration = make_trpo_iteration(env, policy, roll, rl_cfg,
                                        trpo_config(self.cfg),
                                        self.cfg.meta_batch_size,
                                        phase=self._ph)

        def step(params, _, gen):
            params, metrics = iteration(params, gen)
            return params, None, metrics

        return step

    def _make_adam_iteration(self, env, policy, roll, rl_cfg: RLConfig):
        """``(params, opt, gen) -> (params, opt, metrics)``: second-order
        PPO or VPG adaptation of a meta-batch and one Adam step on the mean
        query loss."""
        iteration = make_adam_iteration(env, policy, roll, rl_cfg, self.algo,
                                        self.cfg.meta_batch_size,
                                        phase=self._ph)

        def step(params, opt, gen):
            return params, opt, iteration(params, opt, gen)

        return step

    def _fused_loop(self, env, policy, roll, rl_cfg: RLConfig, params, opt,
                    gen, start: int = 0) -> int:
        """All iterations in chunks of ``cfg.fuse`` (``rl/train_scan.py``,
        ``trainers/fused.py:run_fused``) -> the last iteration."""
        cfg = self.cfg
        if self.algo == "trpo":
            train = make_trpo_train_scan(env, policy, roll, rl_cfg,
                                         trpo_config(cfg),
                                         cfg.meta_batch_size, cfg.fuse)

            def run_chunk(n, state, g):
                p, ms = train(state[0], g, n)
                return (p, state[1]), ms
        else:
            train = make_adam_train_scan(env, policy, roll, rl_cfg,
                                         self.algo, cfg.meta_batch_size,
                                         cfg.fuse)

            def run_chunk(n, state, g):
                p, o, ms = train(*state, g, n)
                return (p, o), ms

        return run_fused(self, run_chunk, (params, opt), gen, start=start,
                         phase=self._ph)

    def run(self) -> dict:
        cfg = self.cfg
        env, _ = make_env(cfg.env, seed=cfg.seed,
                          max_path_length=cfg.max_path_length)
        policy = build_policy(env, self.anil, fc_neurons=cfg.fc_neurons,
                              activation=cfg.activation)
        if cfg.bf16:
            # every policy application (rollouts, inner and outer losses,
            # surrogate and KL, the meta-test) runs its MLP in bf16 on f32
            # master params (models/policies.py compute_dtype)
            policy = policy._replace(compute_dtype="bf16")
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        params = policy.init(gen)
        self.log_model(params)
        rl_cfg = rl_config(cfg, self.anil)
        roll = make_rollout(env, policy.sample,
                            episodes=cfg.adapt_batch_size,
                            horizon=cfg.max_path_length)
        if self.algo == "trpo":
            # TRPO's natural-gradient step is stateless
            state = None
            step_fn = self._make_trpo_iteration(env, policy, roll, rl_cfg)
        else:
            # the Adam leaves, stepped in place
            params = tree_map(torch.Tensor.requires_grad_, params)
            state = adam(params, cfg.outer_lr)
            step_fn = self._make_adam_iteration(env, policy, roll, rl_cfg)
        start_iteration = 0
        if cfg.resume:
            # in place, before the first chunk: a capture takes the loaded
            # tensors (the Adam state is loaded into state when saved)
            params, _, gen, start_iteration = resume_training(
                cfg.resume, params, state, gen)

        start = time.perf_counter()
        iteration = start_iteration
        trace = (device_trace(cfg.trace) if cfg.trace
                 else contextlib.nullcontext())
        try:
            with trace:
                if cfg.fuse > 1:
                    iteration = self._fused_loop(env, policy, roll, rl_cfg,
                                                 params, state, gen,
                                                 start=start_iteration)
                    params = self._fused_params
                else:
                    for iteration in range(start_iteration,
                                           cfg.num_iterations):
                        params, state, metrics = step_fn(params, state, gen)
                        metrics = host_metrics(metrics)
                        print(f"iteration {iteration}: {metrics}",
                              flush=True)
                        self.log_metrics(metrics)
                        if iteration % cfg.save_every == 0:
                            self.save_model_checkpoint(
                                params, iteration, opt_state=state, gen=gen,
                                async_write=cfg.async_ckpt)
        except (KeyboardInterrupt, DivergenceError) as stop:
            if cfg.fuse > 1:
                # the COUNT of iterations in whole chunks (= rows of
                # metrics.json before the stop) and their params
                iteration, params = self._fused_count, self._fused_params
            self.mark_stopped(stop, iteration)

        self.flush_checkpoints()
        self.save_model(params)
        self.logger["elapsed_time"] = (
            f"{round(time.perf_counter() - start, 2)} sec")
        if self._timer:
            self._timer.save(os.path.join(self.model_path,
                                          "phase_times.json"))
            print("Phase times:", self._timer.summary())

        # the generator only moves forward, so the meta-test draws numbers
        # that no training iteration (eager or replayed) drew
        final = meta_test(self.algo, cfg.env, policy, params, rl_cfg,
                          n_tasks=cfg.n_eval_tasks, gen=gen, seed=cfg.seed)
        print("Final evaluation:", final["mean_reward"],
              "success:", final["mean_success"])
        self.logger["final_eval"] = final
        self.log_metrics({"eval_reward": final["mean_reward"],
                          "eval_success": final["mean_success"]})
        self.save_logs_to_file()
        return final
