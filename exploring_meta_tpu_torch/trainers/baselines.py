"""Non-meta baselines: plain PPO / TRPO, a random policy, supervised vision
(port of ``exploring_meta_tpu/trainers/baselines.py``; reference
``baselines/{ppo,trpo,random,vision}.py``).

Each trains one policy or classifier across tasks with no inner loop, then
meta-tests it with few-step MAML adaptation post hoc (reference
``baselines/ppo.py:135-136``, ``baselines/vision.py:141-143``): the control
experiments that show what meta-learning adds.

The RL baselines take one task at a time, as a task batch of one ``[1,
...]``, so the port's batched functions run at B = 1: every rollout is
``[1, T, E, ...]``, and its advantages launch both sweep kernels once
(``discount_sweep`` alone for the random policy). The vision baseline takes
one Adam step per sampled task, in order, on that task's ``2 * ways *
shots`` images as one batch-stat BN batch: on the Omniglot spec under
``conv_impl="fused"`` those are the CNN4 kernels at B = 1.

As in JAX, the meta-trainers' extras (``_UNSUPPORTED``) are ignored with a
printed note, and the run utilities that JAX's ``Experiment`` honours
(``--wandb``, ``--compile_cache``) are honoured. Device envs only: a host
env raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from exploring_meta_tpu_torch.adapt.maml import (
    adam, apply_meta_gradient, make_meta_eval,
)
from exploring_meta_tpu_torch.adapt.vision import make_vision_fast_adapt
from exploring_meta_tpu_torch.device import resolve_device
from exploring_meta_tpu_torch.envs.factory import make_env
from exploring_meta_tpu_torch.models.cnn4 import cnn4_apply, init_cnn4
from exploring_meta_tpu_torch.models.distributions import (
    normal_kl, normal_log_prob,
)
from exploring_meta_tpu_torch.models.layers import set_conv_impl
from exploring_meta_tpu_torch.ops.gae import discount
from exploring_meta_tpu_torch.ops.losses import (
    accuracy, cross_entropy, ppo_policy_loss, trpo_policy_loss,
)
from exploring_meta_tpu_torch.ops.value import fit_linear_value
from exploring_meta_tpu_torch.rl.adapt_rl import (
    masked_mean, normalized_advantages,
)
from exploring_meta_tpu_torch.rl.evaluate import meta_test
from exploring_meta_tpu_torch.rl.rollout import make_rollout
from exploring_meta_tpu_torch.rl.trpo_meta import (
    natural_gradient_step, ravel,
)
from exploring_meta_tpu_torch.tasks.datasets import get_dataset
from exploring_meta_tpu_torch.tasks.sampler import sample_task_batch
from exploring_meta_tpu_torch.trainers.fused import host_metrics
from exploring_meta_tpu_torch.trainers.rl import (
    build_policy, rl_config, trpo_config,
)
from exploring_meta_tpu_torch.trainers.vision import _build_spec
from exploring_meta_tpu_torch.utils.config import (
    CONV_IMPLS, RLScriptConfig, VisionConfig, raise_unported,
)
from exploring_meta_tpu_torch.utils.experiment import (
    DivergenceError, Experiment,
)
from exploring_meta_tpu_torch.utils.tree import tree_leaves, tree_map

_UNSUPPORTED = ("bf16", "mesh", "fuse", "resume", "profile", "trace",
                "async_ckpt", "task_batch", "host_policy", "ckpt_backend")


def _warn_unsupported(cfg) -> None:
    """The baseline trainers keep the reference's simple training loops
    (``baselines/*.py``) and do not implement the meta-trainers' extras;
    say so instead of silently ignoring an advertised flag."""
    defaults = type(cfg)()
    ignored = [f for f in _UNSUPPORTED
               if getattr(cfg, f, None) != getattr(defaults, f, None)]
    if ignored:
        print(f"[baselines] note: not supported by the baseline trainers, "
              f"ignored: {', '.join(ignored)}")


def _check_ported(trainer: str, env: str) -> None:
    """Raise, before a run dir is made, on what JAX's baselines run and the
    port does not yet: a host ``env``."""
    raise_unported(trainer, [(not env.startswith("Particles2D"),
                              f"env={env!r}", "host envs")])


# ---------------------------------------------------------------------------
# RL baselines
# ---------------------------------------------------------------------------

def _setup_rl_baseline(cfg: RLScriptConfig):
    """Env, policy and rollout shared by the RL baselines -> ``(env,
    is_device, policy, roll)``. Device envs only: ``make_env`` raises on a
    host env, naming its ROADMAP item."""
    _warn_unsupported(cfg)
    env, is_device = make_env(cfg.env, workers=cfg.adapt_batch_size,
                              seed=cfg.seed,
                              max_path_length=cfg.max_path_length)
    policy = build_policy(env, anil=False, activation=cfg.activation)
    roll = make_rollout(env, policy.sample, episodes=cfg.adapt_batch_size,
                        horizon=cfg.max_path_length)
    return env, is_device, policy, roll


def _task_at(tasks: torch.Tensor, i: int) -> torch.Tensor:
    """Task ``i`` of a sampled batch as a task batch of one, ``[1, ...]``."""
    return tasks[i:i + 1]


def _average_return(traj) -> torch.Tensor:
    """The rollout's valid reward summed over steps and averaged over its
    episodes."""
    return (traj.reward * traj.valid).sum() / traj.n_episodes


def ppo_update(policy, params, opt, traj, rl_cfg):
    """``rl_cfg.ppo_epochs`` clipped-surrogate Adam steps of ``opt`` on one
    rollout ``[1, T, E, ...]``; the params are stepped in place -> (the
    mean loss over the epochs, the average return), device scalars."""
    adv = normalized_advantages(traj, rl_cfg)
    states, actions = traj.flat(traj.state), traj.flat(traj.action)
    valid = traj.flat(traj.valid).unsqueeze(-1)
    with torch.no_grad():
        old_lp = policy.log_prob(params, states, actions)
    total = 0.0
    for _ in range(rl_cfg.ppo_epochs):
        loss = ppo_policy_loss(policy.log_prob(params, states, actions),
                               old_lp, adv, clip=rl_cfg.ppo_clip_ratio,
                               valid=valid).sum()
        apply_meta_gradient(opt, loss, params)
        total = total + loss.detach()
    return total / rl_cfg.ppo_epochs, _average_return(traj)


def trpo_update(policy, params, traj, rl_cfg, trpo_cfg):
    """A full single-task TRPO update on one rollout ``[1, T, E, ...]``
    (reference ``baselines/trpo.py``): the surrogate on the mean log-prob
    over the action axis, the masked mean KL against the detached old
    ``(loc, scale)``, CG against its Fisher, the trust-region scaling and
    the line search from ``outer_lr`` -> (new params, the average return,
    the step's info, ``index`` the accepted candidate's, -1 for none)."""
    adv = normalized_advantages(traj, rl_cfg)
    states, actions = traj.flat(traj.state), traj.flat(traj.action)
    valid = traj.flat(traj.valid).unsqueeze(-1)
    flat0, unravel = ravel(params)
    with torch.no_grad():
        old_loc, old_scale = policy.density(params, states)
        old_lp = normal_log_prob(old_loc, old_scale, actions).mean(
            dim=-1, keepdim=True)

    def loss_kl(flat):
        loc, scale = policy.density(unravel(flat), states)
        new_lp = normal_log_prob(loc, scale, actions).mean(dim=-1,
                                                           keepdim=True)
        return (trpo_policy_loss(new_lp, old_lp, adv, valid=valid).sum(),
                masked_mean(normal_kl(loc, scale, old_loc, old_scale),
                            valid).sum())

    final, info = natural_gradient_step(loss_kl, flat0, trpo_cfg)
    new_params = tree_map(lambda t: t.detach().clone(), unravel(final))
    return new_params, _average_return(traj), info


def random_policy_fit(traj, gamma: float):
    """One rollout ``[1, T, E, ...]`` of the untrained policy -> (the
    average return, the linear baseline fitted on its discounted returns
    ``[1, D, 1]``; ``discount_sweep``)."""
    returns = discount(gamma, traj.reward, traj.done)
    w = fit_linear_value(traj.flat(traj.state), traj.flat(traj.timestep),
                         traj.flat(returns), weights=traj.flat(traj.valid))
    return _average_return(traj), w


class _RLBaseline(Experiment):
    """The shared loop: per iteration a batch of tasks, one rollout and one
    update each, in order; the metrics of an iteration reach the host in
    one copy; checkpoints ``model_<iteration + 1>`` on the ``save_every``
    cadence; then the model is saved and meta-tested with ``test_algo``
    adaptation (``test_reward`` in the logger, and in the metrics where JAX
    logs it there)."""

    name = default_path = test_algo = ""
    log_test_reward = True

    def __init__(self, cfg: RLScriptConfig, path: str | None = None,
                 device=None):
        _check_ported(type(self).__name__, cfg.env)
        self.device = resolve_device(device)
        super().__init__(self.name, cfg.env, cfg.to_params(),
                         path=path or self.default_path,
                         use_wandb=cfg.use_wandb)
        self.cfg = cfg

    def _start(self):
        """-> (env, policy, roll, params, generator)."""
        env, _, policy, roll = _setup_rl_baseline(self.cfg)
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        return env, policy, roll, policy.init(gen), gen

    def _train(self, env, gen, task_step, save) -> int:
        """``task_step(task) -> {metric: device scalar}`` for each task of
        each iteration; ``save(iteration)`` on the cadence -> the last
        iteration."""
        cfg, iteration = self.cfg, 0
        try:
            for iteration in range(cfg.num_iterations):
                tasks = env.sample_tasks(gen, cfg.meta_batch_size)
                rows = [task_step(_task_at(tasks, i))
                        for i in range(cfg.meta_batch_size)]
                metrics = host_metrics({k: torch.stack([r[k] for r in rows])
                                        .mean() for k in rows[0]})
                print(f"iteration {iteration}: {metrics}", flush=True)
                self.log_metrics(metrics)
                if iteration % cfg.save_every == 0:
                    save(iteration)
        except (KeyboardInterrupt, DivergenceError) as stop:
            self.mark_stopped(stop, iteration)
        return iteration

    def _finish(self, env, policy, gen, params, task_step, save=None) -> dict:
        """Train with ``task_step`` (which updates ``params`` in place),
        save the model and meta-test it -> the meta-test's metrics."""
        cfg = self.cfg
        start = time.perf_counter()
        self._train(env, gen, task_step, save or (
            lambda i: self.save_model_checkpoint(params, i + 1)))
        self.save_model(params)
        self.logger["elapsed_time"] = (
            f"{round(time.perf_counter() - start, 2)} sec")
        final = meta_test(self.test_algo, cfg.env, policy, params,
                          rl_config(cfg), n_tasks=cfg.n_eval_tasks, gen=gen,
                          seed=cfg.seed)
        self.logger["test_reward"] = final["mean_reward"]
        if self.log_test_reward:
            self.log_metrics({"test_reward": final["mean_reward"]})
        self.save_logs_to_file()
        return final


class PPOBaseline(_RLBaseline):
    """Plain PPO across tasks (reference ``baselines/ppo.py``): per task one
    rollout, then ``ppo_epochs`` Adam steps on the clipped surrogate."""

    name, default_path, test_algo = "ppo", "ppo_results/", "ppo"

    def run(self) -> dict:
        cfg = self.cfg
        env, policy, roll, params, gen = self._start()
        params = tree_map(torch.Tensor.requires_grad_, params)
        opt = adam(params, cfg.outer_lr)
        rl_cfg = rl_config(cfg)

        def task_step(task):
            loss, rew = ppo_update(policy, params, opt,
                                   roll(params, task, gen), rl_cfg)
            return {"average_return": rew, "loss": loss}

        return self._finish(env, policy, gen, params, task_step)


class TRPOBaseline(_RLBaseline):
    """Plain single-task TRPO across tasks (reference
    ``baselines/trpo.py``): a full KL / Fisher / CG / line-search update
    per task. ``outer_lr`` (0.1 by default) scales the line search's first
    candidate, as in JAX: a tenth of the natural step. Its meta-test
    reward goes to the logger only, as in JAX."""

    name, default_path, test_algo = "trpo", "trpo_results/", "trpo"
    log_test_reward = False

    def run(self) -> dict:
        env, policy, roll, params, gen = self._start()
        rl_cfg, trpo_cfg = rl_config(self.cfg), trpo_config(self.cfg)

        def task_step(task):
            new, rew, _ = trpo_update(policy, params,
                                      roll(params, task, gen), rl_cfg,
                                      trpo_cfg)
            for p, q in zip(tree_leaves(params), tree_leaves(new)):
                p.copy_(q)
            return {"average_return": rew}

        return self._finish(env, policy, gen, params, task_step)


class RandomPolicyBaseline(_RLBaseline):
    """Random-policy control (reference ``baselines/random.py:65-115``):
    roll the untrained policy over sampled tasks, log ``average_return``,
    checkpoint the policy and the linear baseline fitted on that
    iteration's last rollout (``baseline_<iteration + 1>.npz``, key
    ``weight``; ``baseline.npz`` at the end), then meta-test with PPO
    adaptation."""

    name, default_path, test_algo = "random", "random_results/", "ppo"

    def run(self) -> dict:
        env, policy, roll, params, gen = self._start()
        self.log_model(params)
        fit = {"w": None}

        def task_step(task):
            rew, fit["w"] = random_policy_fit(roll(params, task, gen),
                                              self.cfg.gamma)
            return {"average_return": rew}

        def save(iteration):
            self.save_model_checkpoint(params, iteration + 1)
            np.savez(os.path.join(self.model_path, "model_checkpoints",
                                  f"baseline_{iteration + 1}.npz"),
                     weight=fit["w"][0].cpu().numpy())

        final = self._finish(env, policy, gen, params, task_step, save)
        if fit["w"] is not None:
            np.savez(os.path.join(self.model_path, "baseline.npz"),
                     weight=fit["w"][0].cpu().numpy())
        return final


# ---------------------------------------------------------------------------
# Vision baseline
# ---------------------------------------------------------------------------

def make_supervised_steps(spec):
    """-> ``steps(params, opt, data [n, N, H, W, C], labels [n, N]) ->
    (mean loss, mean accuracy)``: one Adam step of ``opt`` per task, in
    order (JAX's ``lax.scan``), on the cross-entropy of ``cnn4_apply`` over
    that task's N images as one BN batch; the params are stepped in
    place."""
    def steps(params, opt, data, labels):
        losses, accs = [], []
        for x, y in zip(data.unbind(0), labels.unbind(0)):
            logits = cnn4_apply(params, spec, x)
            loss = cross_entropy(logits, y)
            apply_meta_gradient(opt, loss, params)
            losses.append(loss.detach())
            accs.append(accuracy(logits.detach(), y))
        return torch.stack(losses).mean(), torch.stack(accs).mean()
    return steps


class VisionBaseline(Experiment):
    """Supervised training on task batches, no inner loop; meta-tested with
    post-hoc MAML adaptation at ``inner_lr = outer_lr`` (reference
    ``baselines/vision.py:141-143``). Each iteration draws
    ``max(1, int(320 / meta_batch_size))`` tasks. Unlike JAX's, it sizes
    its synthetic data by ``synth_classes`` / ``synth_per_class``, as the
    meta-trainer does."""

    def __init__(self, cfg: VisionConfig, path: str = "results/",
                 device=None):
        self.device = resolve_device(device)
        super().__init__("baseline", cfg.dataset, cfg.to_params(), path=path,
                         use_wandb=cfg.use_wandb)
        self.cfg = cfg

    def run(self) -> float:
        cfg, dev = self.cfg, self.device
        _warn_unsupported(cfg)
        train_ds, _, test_ds = get_dataset(
            cfg.dataset, seed=cfg.seed, synthetic=cfg.synthetic or None,
            synth_classes=cfg.synth_classes,
            synth_per_class=cfg.synth_per_class, device=dev)
        # Always set it: an earlier trainer in this process may have left
        # the module default on another lowering.
        set_conv_impl(CONV_IMPLS.get(cfg.conv_impl, cfg.conv_impl))
        spec = _build_spec(cfg, anil=False)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        params = tree_map(torch.Tensor.requires_grad_,
                          init_cnn4(gen, spec, device=dev))
        opt = adam(params, cfg.outer_lr)
        self.log_model(params)
        steps = make_supervised_steps(spec)

        n_batch_iter = max(1, int(320 / cfg.meta_batch_size))
        start = time.perf_counter()
        iteration = 0
        try:
            for iteration in range(cfg.num_iterations):
                data, labels = sample_task_batch(gen, train_ds, cfg.ways,
                                                 cfg.shots, n_batch_iter)
                loss, acc = steps(params, opt, data, labels)
                metrics = host_metrics({"train_loss": loss,
                                        "train_acc": acc})
                print(f"iteration {iteration}: {metrics}", flush=True)
                self.log_metrics(metrics)
                if iteration % cfg.save_every == 0:
                    self.save_model_checkpoint(params, iteration)
        except (KeyboardInterrupt, DivergenceError) as stop:
            self.mark_stopped(stop, iteration)

        self.save_model(params)
        self.logger["elapsed_time"] = (
            f"{round(time.perf_counter() - start, 2)} sec")

        meta_eval = make_meta_eval(make_vision_fast_adapt(
            spec, inner_lr=cfg.outer_lr, adapt_steps=1, shots=cfg.shots,
            ways=cfg.ways))
        data, labels = sample_task_batch(gen, test_ds, cfg.ways, cfg.shots,
                                         cfg.meta_batch_size)
        test_acc = float(meta_eval(params, data, labels)["metric"])
        print("Meta Test Accuracy", test_acc)
        self.logger["test_acc"] = test_acc
        self.save_logs_to_file()
        return test_acc
