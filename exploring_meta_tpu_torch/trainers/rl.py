"""Meta-RL trainer: MAML/ANIL x TRPO/PPO/VPG (port of
``exploring_meta_tpu/trainers/rl.py``; reference
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

Host envs (MuJoCo AntDirection, Meta-World) collect on the host
(``envs/host.py``) and take the outer steps on the card from the stored
replays: per task, in JAX's order (task i's support rollout, its inner
step, its query rollout, then task i + 1), or with ``--task_batch`` all
tasks in lockstep through one ``meta_batch x episodes``-slot vec env
(``rl/host_batched.py``). ``--workers`` caps the native pool's threads,
``--host_policy cpu`` runs the per-step policy forwards on the CPU, and
``--fuse N`` is ignored on host envs, as in JAX (a host step cannot be
captured).

``--mesh N`` runs the task axis data-parallel over N ranks
(``parallel/launch.py``, ``parallel/mesh.py``) with JAX's semantics per
path: eager TRPO (device or host env) and host-env PPO / VPG collect the
whole meta-batch on every rank and shard the outer step over the ranks;
fused TRPO, and PPO / VPG on a device env (eager or fused), sample and
adapt ``meta_batch / N`` tasks a rank from the rank's own generator
(``parallel/mesh.py:rank_generator``). Rank 0 alone writes the run dir
and meta-tests.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from exploring_meta_tpu_torch.adapt.maml import adam, apply_meta_gradient
from exploring_meta_tpu_torch.device import resolve_device
from exploring_meta_tpu_torch.envs.factory import make_env
from exploring_meta_tpu_torch.models.policies import (
    DiagNormalPolicy, DiagNormalPolicyANIL,
)
from exploring_meta_tpu_torch.parallel.launch import current_rank
from exploring_meta_tpu_torch.parallel.mesh import (
    make_sharded_replay_meta_step, make_sharded_trpo_meta_step,
    rank_generator, shard_task_batch,
)
from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig, make_trpo_collect
from exploring_meta_tpu_torch.rl.evaluate import meta_test
from exploring_meta_tpu_torch.rl.replay_meta import (
    collect_replays, make_replay_meta_loss,
)
from exploring_meta_tpu_torch.rl.rollout import Trajectory, make_rollout
from exploring_meta_tpu_torch.rl.train_scan import (
    make_adam_iteration, make_adam_train_scan, make_trpo_iteration,
    make_trpo_train_scan,
)
from exploring_meta_tpu_torch.rl.trpo_meta import (
    TRPOConfig, make_trpo_meta_step,
)
from exploring_meta_tpu_torch.trainers.fused import host_metrics, run_fused
from exploring_meta_tpu_torch.utils.config import RLScriptConfig
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


def _cat_tasks(rows: list):
    """Per-task results ``[1, ...]`` (params trees or Trajectories) -> one
    ``[B, ...]`` along the task axis."""
    if isinstance(rows[0], Trajectory):
        return Trajectory(*(torch.cat(xs) for xs in zip(*rows)))
    return tree_map(lambda *xs: torch.cat(xs), *rows)


class RLTrainer(Experiment):
    """Meta-RL training loop; ``algo`` is ``"trpo"``, ``"ppo"`` or
    ``"vpg"``.

    ``device`` defaults to the card; pass ``device="cpu"`` to train on the
    CPU. Without a card the default raises before any run dir is made."""

    launches_ranks = True

    def __init__(self, cfg: RLScriptConfig, algo: str = "trpo",
                 anil: bool = False, path: str = "results/", device=None):
        if algo not in ALGOS:
            raise ValueError(f"unknown algo {algo!r} (one of {ALGOS})")
        self.device = resolve_device(device)
        super().__init__(f"{'anil' if anil else 'maml'}_{algo}", cfg.env,
                         cfg.to_params(), path=path,
                         use_wandb=cfg.use_wandb)
        self.cfg = cfg
        self.algo = algo
        self.anil = anil
        self._timer = PhaseTimer() if cfg.profile else None
        self.ckpt_backend = cfg.ckpt_backend
        # the task mesh and this rank's generator, set by run() in a
        # launched rank
        self._mesh = self._rank_gen = None

    def _ph(self, name: str):
        """A ``--profile`` phase (a no-op when profiling is off)."""
        return self._timer.phase(name) if self._timer else no_phase(name)

    def _trpo_meta_step(self, policy, rl_cfg: RLConfig):
        """The eager TRPO outer step ``(params, old_params, replays) ->
        (params, info)``: with a mesh, each rank takes its contiguous shard
        of the globally collected batch and the step is the sharded one
        (JAX's ``_make_trpo_meta_step``)."""
        if self._mesh is None:
            return make_trpo_meta_step(policy, rl_cfg, trpo_config(self.cfg),
                                       rl_cfg.adapt_steps)
        mesh = self._mesh
        step = make_sharded_trpo_meta_step(policy, rl_cfg,
                                           trpo_config(self.cfg),
                                           rl_cfg.adapt_steps, mesh)

        def meta_step(params, old_params, replays):
            return step(params, *shard_task_batch(mesh, (old_params,
                                                         replays)))

        return meta_step

    def _replay_outer(self, policy, rl_cfg: RLConfig):
        """The Adam outer step on recorded replays ``(params, opt,
        replays) -> loss``: with a mesh, on this rank's shard with the
        gradients reduced (JAX's ``_make_adam_replay_outer``)."""
        if self._mesh is None:
            meta_loss = make_replay_meta_loss(self.algo, policy, rl_cfg)

            def outer(params, opt, replays):
                loss = meta_loss(params, replays)
                apply_meta_gradient(opt, loss, params)
                return loss.detach()
            return outer
        mesh = self._mesh
        step = make_sharded_replay_meta_step(policy, rl_cfg, self.algo, mesh)
        return lambda params, opt, replays: step(
            params, opt, shard_task_batch(mesh, replays))[2]

    def _make_trpo_iteration(self, env, policy, roll, rl_cfg: RLConfig):
        """``(params, None, gen) -> (params, None, metrics)``; the line
        search stops at the first accepted candidate."""
        iteration = make_trpo_iteration(env, policy, roll, rl_cfg,
                                        trpo_config(self.cfg),
                                        self.cfg.meta_batch_size,
                                        phase=self._ph,
                                        meta_step=self._trpo_meta_step(
                                            policy, rl_cfg))

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
                                        phase=self._ph, mesh=self._mesh)

        def step(params, opt, gen):
            # with a mesh, the rank's own tasks from its own generator
            return params, opt, iteration(params, opt,
                                          self._rank_gen or gen)

        return step

    def _make_host_trpo_iteration(self, env, policy, roll, rl_cfg: RLConfig):
        """Host-env TRPO, per task in JAX's order: each task's first-order
        collection is the batched one on a ``[1]`` task slice, and the
        stacked replays take the device path's outer step."""
        collect = make_trpo_collect(policy, roll, rl_cfg)
        meta_step = self._trpo_meta_step(policy, rl_cfg)

        def step(params, _, gen):
            tasks = env.sample_tasks(gen, self.cfg.meta_batch_size)
            with self._ph("collect"):
                rows = [collect(params, tasks[i:i + 1], gen)
                        for i in range(len(tasks))]
            with self._ph("meta_step") as sync:
                params, info = meta_step(params,
                                         _cat_tasks([r[0] for r in rows]),
                                         _cat_tasks([r[2] for r in rows]))
                sync.append(params)
            return params, None, {
                "adapt_reward": torch.cat([r[3]["reward"]
                                           for r in rows]).mean(),
                "adapt_success": torch.cat([r[3]["success"]
                                            for r in rows]).mean(),
                "meta_loss": info["old_loss"],
                "ls_accepted": info["accepted"]}

        return step

    def _make_host_adam_iteration(self, env, policy, roll, rl_cfg: RLConfig):
        """Host-env PPO / VPG, per task in JAX's order: each task's
        collection records its replays without a graph
        (``rl/replay_meta.py:collect_replays`` on a ``[1]`` task slice);
        the Adam step takes the second-order meta-gradient of the mean
        query loss rederived from all of them."""
        outer = self._replay_outer(policy, rl_cfg)

        def step(params, opt, gen):
            tasks = env.sample_tasks(gen, self.cfg.meta_batch_size)
            with self._ph("collect"):
                rows = [collect_replays(self.algo, policy, params, roll,
                                        tasks[i:i + 1], gen, rl_cfg)
                        for i in range(len(tasks))]
            with self._ph("meta_step") as sync:
                loss = outer(params, opt, _cat_tasks([r[0] for r in rows]))
                sync.append(params)
            return params, opt, {
                "meta_loss": loss,
                "adapt_reward": torch.cat([r[1]["reward"]
                                           for r in rows]).mean(),
                "adapt_success": torch.cat([r[1]["success"]
                                            for r in rows]).mean()}

        return step

    def _make_host_batched_iteration(self, env, policy, roll,
                                     rl_cfg: RLConfig):
        """``--task_batch`` on a host env: the whole meta-batch collects in
        lockstep (``rl/host_batched.py``), ``meta_batch`` times fewer
        policy round trips than per task, then the replay outer step (TRPO's
        natural gradient, or Adam through the rederived query losses)."""
        from exploring_meta_tpu_torch.rl.host_batched import (
            collect_task_batched,
        )
        if self.algo == "trpo":
            meta_step = self._trpo_meta_step(policy, rl_cfg)
        else:
            outer = self._replay_outer(policy, rl_cfg)

        def step(params, opt, gen):
            tasks = env.sample_tasks(gen, self.cfg.meta_batch_size)
            with self._ph("collect") as sync:
                old, replays, m = collect_task_batched(
                    self.algo, policy, params, roll, tasks, gen, rl_cfg)
                sync.append(replays.reward)
            with self._ph("meta_step") as sync:
                if self.algo == "trpo":
                    params, info = meta_step(params, old, replays)
                    loss = info["old_loss"]
                    extra = {"ls_accepted": info["accepted"]}
                else:
                    loss, extra = outer(params, opt, replays), {}
                sync.append(params)
            return params, opt, {"meta_loss": loss,
                                 "adapt_reward": m["reward"],
                                 "adapt_success": m["success"], **extra}

        return step

    def _fused_loop(self, env, policy, roll, rl_cfg: RLConfig, params, opt,
                    gen, start: int = 0) -> int:
        """All iterations in chunks of ``cfg.fuse`` (``rl/train_scan.py``,
        ``trainers/fused.py:run_fused``) -> the last iteration."""
        cfg, mesh = self.cfg, self._mesh
        # with a mesh, each rank samples its share from its own generator
        rank_gen = self._rank_gen or gen
        if self.algo == "trpo":
            train = make_trpo_train_scan(env, policy, roll, rl_cfg,
                                         trpo_config(cfg),
                                         cfg.meta_batch_size, cfg.fuse,
                                         mesh=mesh)

            def run_chunk(n, state, g):
                p, ms = train(state[0], rank_gen, n)
                return (p, state[1]), ms
        else:
            train = make_adam_train_scan(env, policy, roll, rl_cfg,
                                         self.algo, cfg.meta_batch_size,
                                         cfg.fuse, mesh=mesh)

            def run_chunk(n, state, g):
                p, o, ms = train(*state, rank_gen, n)
                return (p, o), ms

        return run_fused(self, run_chunk, (params, opt), gen, start=start,
                         phase=self._ph)

    def run(self) -> dict | None:
        """-> the final evaluation (None on a launched rank but 0)."""
        if self.cfg.mesh > 1 and current_rank() is None:
            return self.run_ranks()
        self._mesh = self.enter_rank()
        cfg = self.cfg
        # task-batched host collection steps the whole meta-batch through
        # one meta_batch x episodes-slot vec env; per-task collection
        # reuses episodes slots. --workers caps the native pool's threads.
        workers = cfg.adapt_batch_size * (
            cfg.meta_batch_size if cfg.task_batch else 1)
        env, is_device = make_env(
            cfg.env, workers=workers, seed=cfg.seed,
            max_path_length=cfg.max_path_length,
            n_threads=cfg.workers if cfg.workers > 1 else None)
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
        if is_device:
            roll = make_rollout(env, policy.sample,
                                episodes=cfg.adapt_batch_size,
                                horizon=cfg.max_path_length)
        else:
            from exploring_meta_tpu_torch.envs import host
            # always set: an earlier trainer in this process may have left
            # the module default on the other placement
            host.set_host_policy_device(cfg.host_policy)
            roll = (host.make_grouped_host_rollout(
                env, policy, cfg.max_path_length, cfg.meta_batch_size,
                cfg.adapt_batch_size) if cfg.task_batch else
                host.make_host_rollout(env, policy, cfg.max_path_length))
        use_fused = cfg.fuse > 1 and is_device
        if self.algo == "trpo":
            # TRPO's natural-gradient step is stateless
            state = None
        else:
            # the Adam leaves, stepped in place
            params = tree_map(torch.Tensor.requires_grad_, params)
            state = adam(params, cfg.outer_lr)
        if not is_device and cfg.task_batch:
            step_fn = self._make_host_batched_iteration(env, policy, roll,
                                                        rl_cfg)
        elif self.algo == "trpo":
            step_fn = (self._make_trpo_iteration if is_device else
                       self._make_host_trpo_iteration)(env, policy, roll,
                                                       rl_cfg)
        else:
            step_fn = (self._make_adam_iteration if is_device else
                       self._make_host_adam_iteration)(env, policy, roll,
                                                       rl_cfg)
        start_iteration = 0
        if cfg.resume:
            # in place, before the first chunk: a capture takes the loaded
            # tensors (the Adam state is loaded into state when saved)
            params, _, gen, start_iteration = resume_training(
                cfg.resume, params, state, gen)
        if self._mesh is not None and is_device and (
                use_fused or self.algo != "trpo"):
            self._rank_gen = rank_generator(self._mesh, gen, cfg.seed,
                                            start_iteration)

        start = time.perf_counter()
        iteration = start_iteration
        trace = (device_trace(cfg.trace) if cfg.trace and self._writer
                 else contextlib.nullcontext())
        try:
            with trace:
                if use_fused:
                    iteration = self._fused_loop(env, policy, roll, rl_cfg,
                                                 params, state, gen,
                                                 start=start_iteration)
                    params = self._fused_params
                else:
                    for iteration in range(start_iteration,
                                           cfg.num_iterations):
                        params, state, metrics = step_fn(params, state, gen)
                        metrics = host_metrics(metrics)
                        if self._writer:
                            print(f"iteration {iteration}: {metrics}",
                                  flush=True)
                        self.log_metrics(metrics)
                        if iteration % cfg.save_every == 0:
                            self.save_model_checkpoint(
                                params, iteration, opt_state=state, gen=gen,
                                async_write=cfg.async_ckpt)
        except (KeyboardInterrupt, DivergenceError) as stop:
            if use_fused:
                # the COUNT of iterations in whole chunks (= rows of
                # metrics.json before the stop) and their params
                iteration, params = self._fused_count, self._fused_params
            self.mark_stopped(stop, iteration)

        self.flush_checkpoints()
        self.save_model(params)
        self.logger["elapsed_time"] = (
            f"{round(time.perf_counter() - start, 2)} sec")
        if self._timer and self._writer:
            self._timer.save(os.path.join(self.model_path,
                                          "phase_times.json"))
            print("Phase times:", self._timer.summary())
        if self._mesh is not None and self._mesh.rank:
            return None

        # the generator only moves forward, so the meta-test draws numbers
        # that no training iteration (eager or replayed) drew
        final = meta_test(self.algo, cfg.env, policy, params, rl_cfg,
                          n_tasks=cfg.n_eval_tasks, gen=gen, seed=cfg.seed,
                          task_batch=cfg.task_batch)
        print("Final evaluation:", final["mean_reward"],
              "success:", final["mean_success"])
        self.logger["final_eval"] = final
        self.log_metrics({"eval_reward": final["mean_reward"],
                          "eval_success": final["mean_success"]})
        self.save_logs_to_file()
        return final
