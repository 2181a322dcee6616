"""What the launched ranks of ``tests/test_torch_mesh*.py`` run.

A spawned rank imports the module of the function it runs, so these live
here, in a module that imports neither JAX nor the JAX package (and that
pytest does not collect). Inputs and results cross as numpy trees and
Python numbers.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from exploring_meta_tpu_torch.adapt.maml import (
    adam, make_meta_eval, make_train_scan,
)
from exploring_meta_tpu_torch.adapt.vision import make_vision_fast_adapt
from exploring_meta_tpu_torch.envs.particles2d import Particles2D
from exploring_meta_tpu_torch.models import cnn4
from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
from exploring_meta_tpu_torch.parallel.launch import current_rank
from exploring_meta_tpu_torch.parallel.mesh import (
    make_sharded_adam_train_scan, make_sharded_meta_step,
    make_sharded_replay_meta_step, make_sharded_trpo_meta_step,
    make_sharded_trpo_train_scan, make_task_mesh, rank_generator,
    replicated_equal, shard_task_batch,
)
from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig
from exploring_meta_tpu_torch.rl.replay_meta import recording_rollout
from exploring_meta_tpu_torch.rl.rollout import Trajectory, make_rollout
from exploring_meta_tpu_torch.rl.trpo_meta import TRPOConfig, stack_replays
from exploring_meta_tpu_torch.tasks import datasets
from exploring_meta_tpu_torch.tasks.sampler import sample_task_batch
from exploring_meta_tpu_torch.utils.tree import tree_leaves, tree_map

HIDDENS = (16, 16)


def numpy_tree(tree):
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def torch_params(tree, grad: bool = False):
    return tree_map(lambda a: torch.tensor(a).requires_grad_(grad), tree)


def traj(fields) -> Trajectory:
    return Trajectory(*(torch.as_tensor(x) for x in fields))


def grads_of(params):
    return tree_map(lambda t: t.grad.detach().numpy().copy(), params)


def vision_fast_adapt(spec_kw: dict, inner_lr: float):
    return make_vision_fast_adapt(cnn4.omniglot_spec(**spec_kw), inner_lr,
                                  1, shots=1, ways=spec_kw["ways"])


def rl_setup(rl: dict):
    env = Particles2D()
    policy = DiagNormalPolicy(2, 2, hiddens=HIDDENS)
    cfg = RLConfig(**rl["cfg"])
    roll = make_rollout(env, policy.sample, episodes=cfg.adapt_batch_size,
                        horizon=cfg.max_path_length)
    return env, policy, cfg, roll


def sharded_step_checks(inp: dict) -> dict:
    """Every sharded factory on this rank's share of ``inp``'s tasks; the
    test holds each against the unsharded step on the whole batch and
    against JAX."""
    mesh = make_task_mesh()
    out = {"rank": mesh.rank, "size": mesh.size, "axis": mesh.axis}

    # the vision meta-step on a shard of one global batch
    v = inp["vision"]
    fa = vision_fast_adapt(v["spec"], v["inner_lr"])
    params = torch_params(v["params"], grad=True)
    opt = adam(params, v["lr"])
    data, labels = shard_task_batch(mesh, (torch.tensor(v["data"]),
                                           torch.tensor(v["labels"]).long()))
    _, _, m = make_sharded_meta_step(fa, mesh)(params, opt, data, labels)
    out["vision_step"] = {
        "grads": grads_of(params), "params": numpy_tree(params),
        "loss": float(m["loss"]), "metric": float(m["metric"]),
        "equal": replicated_equal(mesh, tree_leaves(params))}

    # the fused vision scan, each rank sampling from its own generator
    train_ds, valid_ds, _ = datasets.get_dataset(
        "omni", seed=0, synthetic=True, device="cpu")
    local = v["meta_batch"] // mesh.size
    drawn: list = []

    def sample(g):
        batch = sample_task_batch(g, train_ds, 5, 1, local)
        drawn.append([x.numpy().copy() for x in batch])
        return batch

    def sample_valid(g):
        return sample_task_batch(g, valid_ds, 5, 1, local)

    params = torch_params(v["params"], grad=True)
    opt = adam(params, v["lr"])
    gen = rank_generator(mesh, torch.Generator().manual_seed(3), seed=3)
    train = make_train_scan(fa, sample, 1, eval_sample_fn=sample_valid,
                            mesh=mesh)
    _, _, ms = train(params, opt, gen, 1)
    first = {"grads": grads_of(params), "params": numpy_tree(params),
             "metrics": {k: float(x[0]) for k, x in ms.items()},
             "batch": drawn[0]}
    equal = [replicated_equal(mesh, tree_leaves(params))]
    for _ in range(2):
        train(params, opt, gen, 1)
        equal.append(replicated_equal(mesh, tree_leaves(params)))
    out["vision_scan"] = {**first, "equal": equal}

    # the TRPO outer step on a shard of JAX's replays
    r = inp["trpo"]
    env, policy, cfg, roll = rl_setup(r)
    trpo_cfg = TRPOConfig(**r["trpo"])
    s_old, s_rep = shard_task_batch(mesh, (torch_params(r["old"]),
                                           traj(r["replays"])))
    for host_free in (False, True):
        step = make_sharded_trpo_meta_step(policy, cfg, trpo_cfg, 1, mesh,
                                           host_free=host_free)
        new, info = step(torch_params(r["params"]), s_old, s_rep)
        out[f"trpo_step_{host_free}"] = {
            "params": numpy_tree(new), "old_loss": float(info["old_loss"]),
            "accepted": bool(info["accepted"]),
            "index": info.get("index"),
            "equal": replicated_equal(mesh, tree_leaves(new))}

    # the PPO replay outer step on a shard of JAX's replays
    p = inp["ppo"]
    _, policy, pcfg, _ = rl_setup(p)
    params = torch_params(p["params"], grad=True)
    opt = adam(params, p["lr"])
    step = make_sharded_replay_meta_step(policy, pcfg, "ppo", mesh)
    _, _, loss = step(params, opt, shard_task_batch(mesh,
                                                    traj(p["replays"])))
    out["replay_step"] = {"grads": grads_of(params),
                          "params": numpy_tree(params), "loss": float(loss),
                          "equal": replicated_equal(mesh,
                                                    tree_leaves(params))}

    # the fused TRPO and PPO scans: each rank's tasks and rollouts recorded
    for algo in ("trpo", "ppo"):
        s = inp[f"{algo}_scan"]
        env, policy, cfg, roll = rl_setup(s)
        store: list = []
        rec = recording_rollout(roll, store)
        params = torch_params(s["params"], grad=algo == "ppo")
        gen = rank_generator(mesh, torch.Generator().manual_seed(5), seed=5)
        if algo == "trpo":
            train = make_sharded_trpo_train_scan(
                env, policy, rec, cfg, TRPOConfig(**s["trpo"]),
                s["meta_batch"], 1, mesh)
            _, ms = train(params, gen, 1)
        else:
            opt = adam(params, s["lr"])
            train = make_sharded_adam_train_scan(
                env, policy, rec, cfg, "ppo", s["meta_batch"], 1, mesh)
            _, _, ms = train(params, opt, gen, 1)
        replays = stack_replays(store[:cfg.adapt_steps + 1])
        first = {"params": numpy_tree(params),
                 "replays": [x.numpy().copy() for x in replays],
                 "metrics": {k: float(x[0]) for k, x in ms.items()}}
        if algo == "ppo":
            first["grads"] = grads_of(params)
        equal = [replicated_equal(mesh, tree_leaves(params))]
        for _ in range(2):
            if algo == "trpo":
                train(params, gen, 1)
            else:
                train(params, opt, gen, 1)
            equal.append(replicated_equal(mesh, tree_leaves(params)))
        out[f"{algo}_scan"] = {**first, "equal": equal}

    # the meta-eval averaged over the ranks
    fa = vision_fast_adapt(v["spec"], v["inner_lr"])
    m = make_meta_eval(fa, mesh=mesh)(torch_params(v["params"]), data,
                                      labels)
    out["meta_eval"] = {k: float(x) for k, x in m.items()}
    return out


def fail_on_rank_one() -> None:
    """Rank 1 raises while rank 0 waits in a collective that rank 1 never
    joins; the launch must fail fast, not at the collective's timeout."""
    mesh = make_task_mesh()
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    mesh.pmean(torch.ones(3))


def whoami() -> dict:
    """A rank's view of itself: its mesh, a pmean, and whether anything of
    JAX is loaded in the process."""
    mesh = make_task_mesh()
    rank = current_rank()
    value = mesh.pmean(torch.tensor([float(mesh.rank), 1.0]))
    return {"rank": rank.rank, "size": rank.size, "backend": rank.backend,
            "device": str(mesh.device), "threads": torch.get_num_threads(),
            "pmean": value.tolist(),
            "jax": sorted(m for m in sys.modules
                          if m.split(".")[0] in ("jax",
                                                 "exploring_meta_tpu"))}


def run_trainers(runs: list) -> list:
    """Each ``(kind, algo, cfg, path)`` trainer run in this rank ->
    rank 0's ``(run dir, metrics, result)``, others' ``None``s."""
    from exploring_meta_tpu_torch.trainers.rl import RLTrainer
    from exploring_meta_tpu_torch.trainers.vision import VisionTrainer
    out = []
    for kind, algo, cfg, path in runs:
        if kind == "vision":
            trainer = VisionTrainer(cfg, anil=algo == "anil", path=path,
                                    device="cpu")
        else:
            trainer = RLTrainer(cfg, algo=algo, path=path, device="cpu")
        result = trainer.run()
        out.append((trainer.model_path, trainer.metrics, result)
                   if current_rank().rank == 0 else None)
    return out
