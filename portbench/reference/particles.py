"""Plain PyTorch meta-RL on Particles2D: the environment, the Gaussian MLP
policy, rollouts, discounting and GAE with the linear baseline, and the
VPG inner step.

Finn et al. 2017 (arXiv:1703.03400) §5.3, as the reference repository runs
it (learn2learn's ``Particles2D-v1``, cherry's ``LinearValue``,
``discount`` and ``generalized_advantage``, ``core_functions/rl.py``):

- A task is a goal ``U[-0.5, 0.5]^2``; a point starts at the origin, an
  action is a displacement clipped to +-0.1, the reward is minus the
  distance to the goal, and an episode ends once both coordinates are
  within 0.01 of it (the point then stays; later steps are masked out).
  Every episode runs the full horizon, and its last valid step is
  terminal.
- The policy's mean is an MLP with ReLU (``max(x, 0)``: at a tie its
  gradient is split, 1/2), its scale ``exp(max(log_sigma, log 1e-6))``
  state-independent; a log-probability is the mean over action dims.
- The baseline is a ridge fit (``reg``) of the discounted returns on
  ``[s, s^2, t/100, (t/100)^2, (t/100)^3, 1]``, ``t`` the step within the
  episode, weighted by the valid mask; at a terminal step GAE sees the
  next state's value in place of the state's.

Trajectories are ``[B, T, E, ...]`` (tasks, steps, episodes); per-task
params carry a leading ``[B]``. Noise is drawn from the generator it is
given, in float32, in the order the iteration uses it (the goals, then
each rollout's steps), so a generator seeded as the program's draws the
program's numbers.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from portbench.reference.precision import Precision

LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
MIN_LOG_SIGMA = math.log(1e-6)


class Traj(NamedTuple):
    state: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    next_state: torch.Tensor
    success: torch.Tensor
    valid: torch.Tensor
    timestep: torch.Tensor


def leaves(params: dict) -> list:
    """The policy's tensors in a fixed order: each layer's ``w``, ``b``,
    then ``sigma``."""
    out = []
    for layer in params["mean"]:
        out += [layer["w"], layer["b"]]
    return out + [params["sigma"]]


def rebuild(tensors: list) -> dict:
    it = iter(tensors)
    n = (len(tensors) - 1) // 2
    return {"mean": [{"w": next(it), "b": next(it)} for _ in range(n)],
            "sigma": next(it)}


def cast(params: dict, prec: Precision) -> dict:
    return rebuild([t.detach().to(prec.dtype) for t in leaves(params)])


def per_task(params: dict, n: int) -> dict:
    return rebuild([t.unsqueeze(0).expand((n,) + t.shape)
                    for t in leaves(params)])


def density(params: dict, s: torch.Tensor, prec: Precision):
    """``(loc, scale)`` ``[B, N, act]`` for states ``[B, N, obs]``; params
    shared or per task."""
    h = s
    layers = params["mean"]
    for i, layer in enumerate(layers):
        b = layer["b"]
        h = h @ layer["w"] + (
            b.unsqueeze(-2) if b.ndim == 2 else b)
        if i < len(layers) - 1:
            h = torch.maximum(h, torch.zeros((), dtype=h.dtype,
                                             device=h.device))
    sigma = params["sigma"]
    sigma = sigma.unsqueeze(-2) if sigma.ndim == 2 else sigma
    scale = torch.exp(torch.clamp(sigma, min=MIN_LOG_SIGMA))
    return h, scale.expand(h.shape)


def log_prob(params, s, a, prec) -> torch.Tensor:
    loc, scale = density(params, s, prec)
    lp = (-((a - loc) ** 2) / (2 * scale ** 2) - torch.log(scale)
          - LOG_SQRT_2PI)
    return lp.mean(dim=-1, keepdim=True)


def sample_goals(gen: torch.Generator, n: int, cfg: dict) -> torch.Tensor:
    u = torch.rand((n, 2), generator=gen, device=gen.device)
    return u - cfg["goal_range"]


@torch.no_grad()
def rollout(params: dict, goals: torch.Tensor, gen: torch.Generator,
            episodes: int, horizon: int, cfg: dict,
            prec: Precision) -> Traj:
    B, dt, dev = goals.shape[0], prec.dtype, goals.device
    goals = goals.to(dt)
    pos = torch.zeros((B, episodes, 2), dtype=dt, device=dev)
    t = torch.zeros((B, episodes), dtype=torch.int32, device=dev)
    done = torch.zeros((B, episodes), dtype=torch.bool, device=dev)
    rec = []
    for _ in range(horizon):
        loc, scale = density(params, pos, prec)
        eps = torch.randn(loc.shape, generator=gen, dtype=torch.float32,
                          device=dev).to(dt)
        action = loc + scale * eps
        step = torch.clamp(action, -cfg["max_action"], cfg["max_action"])
        new_pos = torch.where(done.unsqueeze(-1), pos, pos + step)
        diff = new_pos - goals.unsqueeze(-2)
        reward = -torch.linalg.vector_norm(diff, dim=-1)
        done_now = (diff.abs() < cfg["goal_threshold"]).all(dim=-1)
        valid = (~done).to(dt)
        now = done | done_now
        rec.append(Traj(pos, action, reward * valid, now.to(dt), new_pos,
                        done_now.to(dt) * valid, valid, t))
        pos, t, done = new_pos, t + 1, now
    traj = Traj(*(torch.stack(xs, dim=1) for xs in zip(*rec)))
    last = traj.done[:, -1]
    last.copy_(torch.maximum(last, traj.valid[:, -1]))
    return traj


def flat(x: torch.Tensor) -> torch.Tensor:
    """``[B, T, E, ...]`` -> ``[B, T*E, ...]``, time-major."""
    return x.reshape(x.shape[:1] + (-1,) + x.shape[3:])


def discount(gamma: float, r: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(r)
    acc = torch.zeros_like(r[:, 0])
    for i in range(r.shape[1] - 1, -1, -1):
        acc = r[:, i] + gamma * (1.0 - d[:, i]) * acc
        out[:, i] = acc
    return out


def gae(gamma: float, tau: float, r, d, v) -> torch.Tensor:
    nv = torch.cat([v[:, 1:], torch.zeros_like(v[:, :1])], dim=1)
    td = r + gamma * (1.0 - d) * nv - v
    return discount(gamma * tau, td, d)


def features(s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    al = t.to(s.dtype).unsqueeze(-1) / 100.0
    return torch.cat([s, s ** 2, al, al ** 2, al ** 3, torch.ones_like(al)],
                     dim=-1)


def fit_baseline(traj: Traj, cfg: dict, prec: Precision) -> torch.Tensor:
    returns = discount(cfg["gamma"], traj.reward, traj.done)
    f = features(flat(traj.state), flat(traj.timestep))
    sw = torch.sqrt(flat(traj.valid)).unsqueeze(-1)
    f, r = f * sw, flat(returns).unsqueeze(-1) * sw
    ft = f.transpose(-1, -2)
    a = ft @ f + cfg["value_reg"] * torch.eye(
        f.shape[-1], dtype=f.dtype, device=f.device)
    return torch.linalg.solve(a, ft @ r)


def advantages(traj: Traj, cfg: dict, prec: Precision, w=None):
    """GAE advantages ``[B, T, E]`` and the baseline's weights (fitted on
    ``traj`` unless ``w`` is given)."""
    if w is None:
        w = fit_baseline(traj, cfg, prec)
    shape = traj.reward.shape
    t = flat(traj.timestep)
    values = (features(flat(traj.state), t) @ w).reshape(shape)
    nxt = (features(flat(traj.next_state), t + 1) @ w).reshape(shape)
    boot = values * (1.0 - traj.done) + nxt * traj.done
    return gae(cfg["gamma"], cfg["tau"], traj.reward, traj.done, boot), w


def masked_mean(x, mask) -> torch.Tensor:
    mask = mask.expand_as(x)
    return (x * mask).flatten(1).sum(1) / mask.flatten(1).sum(1).clamp(
        min=1.0)


def a2c_loss(params, traj: Traj, adv_flat, prec) -> torch.Tensor:
    """``[B]`` valid-weighted ``-(log pi * A)`` means."""
    lp = log_prob(params, flat(traj.state), flat(traj.action), prec)
    valid = flat(traj.valid).unsqueeze(-1)
    return -masked_mean(lp * adv_flat, valid)


def inner_step(params, loss_fn, lr: float, create_graph: bool):
    """``p - lr * grad``; kept to second order only where ``create_graph``
    and gradients are on (under ``no_grad`` nothing differentiates it)."""
    create_graph = create_graph and torch.is_grad_enabled()
    x = leaves(params)
    if not create_graph:
        x = [t.detach().requires_grad_() for t in x]
    with torch.enable_grad():
        loss = loss_fn(rebuild(x)).sum()
        grads = torch.autograd.grad(loss, x, create_graph=create_graph)
    return rebuild([p - lr * g for p, g in zip(x, grads)])


def vpg_adapt(params, support: Traj, cfg: dict, prec: Precision) -> dict:
    """One first-order VPG step of per-task params on a support batch
    (raw GAE advantages)."""
    adv, _ = advantages(support, cfg, prec)
    adv = flat(adv).unsqueeze(-1).detach()
    new = inner_step(params, lambda p: a2c_loss(p, support, adv, prec),
                     cfg["inner_lr"], create_graph=False)
    return rebuild([t.detach() for t in leaves(new)])
