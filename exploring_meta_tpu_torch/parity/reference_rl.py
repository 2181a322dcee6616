"""Torch reproduction of the reference's MAML-TRPO / MAML-PPO / MAML-VPG
training (the port's copy of ``scripts/torch_rl_repro.py``).

The plain reference of ``parity/check.py --rl``: a faithful
re-implementation of the reference's meta-RL math (its
``core_functions/rl.py``) and training loops (``rl/maml_trpo.py:82-153``,
``rl/maml_ppo.py:81-149``) on a numpy Particles2D with l2l-identical
dynamics, so that the port's RL tier can be accuracy-checked end to end
against the reference algorithm on the same task distribution. It is
independent of the port's own RL code (``rl/``, ``ops/``, ``envs/``) and
runs on the CPU: tasks from a numpy generator, rollout noise from an
explicit ``torch.Generator``, one env step at a time in Python.

Faithfulness notes (reference file:line):
- Particles2D: clip actions to +-0.1, reward = -||pos - goal||, done on
  the per-coordinate box |dx|<0.01 and |dy|<0.01 (l2l Particles2DEnv).
- DiagNormalPolicy: 2x100 ReLU MLP, xavier-uniform + zero-bias init,
  state-independent log-sigma init 0 clamped at log(1e-6), log_prob
  averaged (not summed) over action dims (policies.py:30-67).
- LinearValue: cherry's features [s, s^2, al, al^2, al^3, 1] with
  ``al = flat replay row index / 100`` (crossing episode boundaries —
  the reference quirk; see ops/value.py). Ridge reg defaults to cherry's
  1e-5, but the reference passes env.action_size as the second positional
  arg of LinearValue (rl/maml_trpo.py:85) — cherry's ``reg`` — so the
  training loops construct reg = action dim (2.0 here); see
  make_baseline / PARITY.md D9.
- compute_advantages (rl.py:95-110): discounted returns -> fit ->
  bootstraps = v*(1-d) + v_next*d -> GAE with trailing next_value 0.
- fast_adapt_trpo (rl.py:377-406): first-order inner updates during
  collection, query loss reuses the last support fit (update_vf=False).
- meta_optimize_trpo (rl.py:409-438): surrogate replay with 2nd-order
  re-adaptation, HVP of mean-KL (damping 1e-5), CG (10 iters, tol 1e-10,
  cherry defaults), trust-region scaling, backtracking line search.
- fast_adapt_ppo (rl.py:264-316): normalized detached advantages,
  no-grad old log-probs, ppo_epochs clipped updates with create_graph
  (the outer Adam differentiates through them, maml_ppo.py:128-130).

Episodes roll out in lockstep across the episode batch (the reference's
own AsyncVectorEnv execution model, env_maker.py:18-21) and are then
flattened episode-major exactly like ``runner.py:10-51``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EPSILON = 1e-6


# ---------------------------------------------------------------------------
# Env (numpy, vectorized over the episode batch)
# ---------------------------------------------------------------------------

MAX_ACTION = 0.1
GOAL_THRESHOLD = 0.01


def sample_tasks(rng: np.random.Generator, n: int) -> np.ndarray:
    """[n, 2] goals ~ U[-0.5, 0.5]^2 (l2l Particles2DEnv.sample_tasks)."""
    return rng.uniform(-0.5, 0.5, size=(n, 2))


# ---------------------------------------------------------------------------
# Policy (functional param dict; architecture/init = policies.py:30-67)
# ---------------------------------------------------------------------------

# ANIL semantics (tanh body, head+sigma-only inner updates with a no-grad
# body pass — reference policies.py:70-126) are selected per call via the
# ``anil`` parameter, threaded down from cfg["anil"] (no module state).


def init_policy(gen: torch.Generator, obs: int = 2, act: int = 2,
                hidden: int = 100) -> dict:
    """Both reference policies share this param structure and init
    (linear_init = xavier-uniform + zero bias on every layer, sigma 0):
    DiagNormalPolicy (relu) and DiagNormalPolicyANIL (tanh body w1/w2 +
    head w3)."""
    def lin(i, o):
        w = torch.empty(o, i)
        torch.nn.init.xavier_uniform_(w, generator=gen)
        return w.requires_grad_(True), torch.zeros(o, requires_grad=True)

    w1, b1 = lin(obs, hidden)
    w2, b2 = lin(hidden, hidden)
    w3, b3 = lin(hidden, act)
    sigma = torch.full((act,), math.log(1.0), requires_grad=True)
    return {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "w3": w3, "b3": b3,
            "sigma": sigma}


def policy_loc(p: dict, states: torch.Tensor, anil: bool = False,
               body_detach: bool = False) -> torch.Tensor:
    act = torch.tanh if anil else torch.relu
    h = act(states @ p["w1"].T + p["b1"])
    h = act(h @ p["w2"].T + p["b2"])
    if body_detach:  # turn_off_body_grads: no-grad body pass (:100-106)
        h = h.detach()
    return h @ p["w3"].T + p["b3"]


def policy_scale(p: dict) -> torch.Tensor:
    return torch.exp(torch.clamp(p["sigma"], min=math.log(EPSILON)))


def policy_density(p: dict, states: torch.Tensor, anil: bool = False,
                   body_detach: bool = False):
    loc = policy_loc(p, states, anil, body_detach)
    return torch.distributions.Normal(loc=loc, scale=policy_scale(p))


def policy_log_prob(p: dict, states, actions, anil: bool = False,
                    body_detach: bool = False) -> torch.Tensor:
    """Mean (not sum) over action dims — the reference quirk
    (policies.py:54-56)."""
    return policy_density(p, states, anil, body_detach).log_prob(
        actions).mean(dim=1, keepdim=True)


PARAM_ORDER = ("w1", "b1", "w2", "b2", "w3", "b3", "sigma")
HEAD_ORDER = ("w3", "b3", "sigma")  # ANIL inner-trainable leaves


def params_list(p: dict) -> list:
    return [p[k] for k in PARAM_ORDER]


def from_list(vals) -> dict:
    return dict(zip(PARAM_ORDER, vals))


def inner_params(p: dict, anil: bool = False) -> list:
    """The leaves the inner loop updates: all (MAML) or head+sigma
    (ANIL — body grads are None under allow_unused)."""
    return [p[k] for k in (HEAD_ORDER if anil else PARAM_ORDER)]


def inner_update(p: dict, grads, lr: float, anil: bool = False) -> dict:
    names = HEAD_ORDER if anil else PARAM_ORDER
    out = dict(p)
    for n, g in zip(names, grads):
        out[n] = out[n] - lr * g
    return out


# ---------------------------------------------------------------------------
# Rollouts -> reference-style flat episode-major replay
# ---------------------------------------------------------------------------

def collect_episodes(p: dict, goal: np.ndarray, episodes: int, horizon: int,
                     gen: torch.Generator, anil: bool = False) -> dict:
    """Roll ``episodes`` lockstep episodes; -> flat [N, .] tensors with
    episodes concatenated in order (runner.py flatten_episodes layout).
    Episodes end at box-done or horizon (horizon step forced done)."""
    pos = np.zeros((episodes, 2), dtype=np.float64)
    alive = np.ones(episodes, dtype=bool)
    per_ep: list = [[] for _ in range(episodes)]
    with torch.no_grad():
        for t in range(horizon):
            states = torch.as_tensor(pos, dtype=torch.float32)
            d = policy_density(p, states, anil)
            actions = torch.normal(d.loc, d.scale, generator=gen).numpy()
            clipped = np.clip(actions, -MAX_ACTION, MAX_ACTION)
            new_pos = pos + clipped
            diff = new_pos - goal[None, :]
            reward = -np.linalg.norm(diff, axis=1)
            done = np.all(np.abs(diff) < GOAL_THRESHOLD, axis=1)
            if t == horizon - 1:
                done = np.ones_like(done)
            for e in range(episodes):
                if alive[e]:
                    per_ep[e].append((pos[e].copy(), actions[e],
                                      reward[e], float(done[e]),
                                      new_pos[e].copy()))
            alive &= ~done
            pos = new_pos
            if not alive.any():
                break

    states, actions, rewards, dones, next_states = [], [], [], [], []
    for ep in per_ep:
        for s, a, r, d, ns in ep:
            states.append(s)
            actions.append(a)
            rewards.append(r)
            dones.append(d)
            next_states.append(ns)
    return {
        "states": torch.tensor(np.array(states), dtype=torch.float32),
        "actions": torch.tensor(np.array(actions), dtype=torch.float32),
        "rewards": torch.tensor(np.array(rewards),
                                dtype=torch.float32).view(-1, 1),
        "dones": torch.tensor(np.array(dones),
                              dtype=torch.float32).view(-1, 1),
        "next_states": torch.tensor(np.array(next_states),
                                    dtype=torch.float32),
        "n_episodes": episodes,
    }


def episode_reward(ep: dict) -> float:
    return float(ep["rewards"].sum().item()) / ep["n_episodes"]


# ---------------------------------------------------------------------------
# cherry LinearValue + advantage pipeline (rl.py:95-110)
# ---------------------------------------------------------------------------

class LinearValue:
    """cherry.models.robotics.LinearValue reproduction: ridge fit over
    [s, s^2, al, al^2, al^3, 1] with al = flat row index / 100."""

    def __init__(self, input_size: int, reg: float = 1e-5):
        self.weight = torch.zeros(2 * input_size + 4, 1)
        self.reg = reg

    @staticmethod
    def _features(states: torch.Tensor) -> torch.Tensor:
        length = states.size(0)
        ones = torch.ones(length, 1)
        al = torch.arange(length, dtype=torch.float32).view(-1, 1) / 100.0
        return torch.cat([states, states ** 2, al, al ** 2, al ** 3, ones],
                         dim=1)

    def fit(self, states, returns):
        f = self._features(states)
        a = f.t() @ f + self.reg * torch.eye(f.size(1))
        b = f.t() @ returns
        self.weight = torch.linalg.solve(a, b)

    def __call__(self, states):
        return self._features(states) @ self.weight


def discount(gamma: float, rewards: torch.Tensor,
             dones: torch.Tensor) -> torch.Tensor:
    """cherry.td.discount: reset accumulation at episode boundaries."""
    out = torch.zeros_like(rewards)
    running = torch.zeros(rewards.shape[1:])
    for t in reversed(range(rewards.size(0))):
        running = rewards[t] + gamma * running * (1.0 - dones[t])
        out[t] = running
    return out


def generalized_advantage(tau, gamma, rewards, dones, values, next_value):
    """cherry.pg.generalized_advantage."""
    next_values = torch.cat([values[1:], next_value.view(1, 1)], dim=0)
    td = rewards + gamma * (1.0 - dones) * next_values - values
    return discount(tau * gamma, td, dones)


def compute_advantages(baseline: LinearValue, tau, gamma, rewards, dones,
                       states, next_states, update_vf: bool = True):
    """Reference rl.py:95-110 (fit is never differentiated through)."""
    returns = discount(gamma, rewards, dones)
    if update_vf:
        baseline.fit(states, returns)
    values = baseline(states)
    next_values = baseline(next_states)
    bootstraps = values * (1.0 - dones) + next_values * dones
    return generalized_advantage(tau, gamma, rewards, dones, bootstraps,
                                 torch.zeros(1))


def ch_normalize(x: torch.Tensor, epsilon: float = 1e-8) -> torch.Tensor:
    return (x - x.mean()) / (x.std() + epsilon)


# ---------------------------------------------------------------------------
# TRPO (rl.py:343-473)
# ---------------------------------------------------------------------------

def trpo_a2c_loss(ep, p, baseline, gamma, tau, update_vf=True,
                  anil=False, body_detach=False):
    log_probs = policy_log_prob(p, ep["states"], ep["actions"], anil,
                                body_detach)
    adv = compute_advantages(baseline, tau, gamma, ep["rewards"],
                             ep["dones"], ep["states"], ep["next_states"],
                             update_vf=update_vf)
    adv = ch_normalize(adv).detach()
    return -(log_probs * adv).mean()


def trpo_update(ep, p, baseline, inner_lr, gamma, tau, second_order,
                anil=False):
    """Inner MAML step (rl.py:361-374); under ANIL the body pass is
    no-grad and only head+sigma move (allow_unused semantics)."""
    loss = trpo_a2c_loss(ep, p, baseline, gamma, tau, anil=anil,
                         body_detach=anil)
    grads = torch.autograd.grad(loss, inner_params(p, anil),
                                retain_graph=second_order,
                                create_graph=second_order)
    return inner_update(p, grads, inner_lr, anil)


def fast_adapt_trpo(p, goal, baseline, cfg, gen):
    """-> (adapted detached params, replay list, query reward).

    Params are re-leafed (detach + requires_grad) between inner steps —
    value-identical to the reference's first-order collection (grads are
    detached inside trpo_update either way) while keeping every step's
    params differentiable, so adapt_steps >= 2 works like rl.py:384-396."""
    anil = bool(cfg.get("anil", False))
    replay = []
    cur = p
    for _ in range(cfg["adapt_steps"]):
        support = collect_episodes(cur, goal, cfg["adapt_batch_size"],
                                   cfg["max_path_length"], gen, anil)
        replay.append(support)
        cur = trpo_update(support, cur, baseline, cfg["inner_lr"],
                          cfg["gamma"], cfg["tau"], second_order=False,
                          anil=anil)
        cur = {k: v.detach().requires_grad_(True) for k, v in cur.items()}
    query = collect_episodes(cur, goal, cfg["adapt_batch_size"],
                             cfg["max_path_length"], gen, anil)
    replay.append(query)
    return cur, replay, episode_reward(query)


def meta_surrogate_loss(iter_replays, iter_policies, p, baseline, cfg):
    """Reference rl.py:441-473: re-run inner adaptations with 2nd-order
    graphs, mean KL + importance-ratio surrogate over query episodes."""
    anil = bool(cfg.get("anil", False))
    mean_loss = 0.0
    mean_kl = 0.0
    for task_replays, old_p in zip(iter_replays, iter_policies):
        new_p = p
        for support in task_replays[:-1]:
            new_p = trpo_update(support, new_p, baseline, cfg["inner_lr"],
                                cfg["gamma"], cfg["tau"], second_order=True,
                                anil=anil)
        query = task_replays[-1]
        states, actions = query["states"], query["actions"]
        with torch.no_grad():
            old_d = policy_density(old_p, states, anil)
        new_d = policy_density(new_p, states, anil)
        kl = torch.distributions.kl_divergence(new_d, old_d).mean()
        mean_kl = mean_kl + kl

        adv = compute_advantages(baseline, cfg["tau"], cfg["gamma"],
                                 query["rewards"], query["dones"],
                                 states, query["next_states"])
        adv = ch_normalize(adv).detach()
        old_lp = old_d.log_prob(actions).mean(dim=1, keepdim=True)
        new_lp = new_d.log_prob(actions).mean(dim=1, keepdim=True)
        # cherry trpo.policy_loss: -(exp(new - old) * adv).mean()
        mean_loss = mean_loss - (torch.exp(new_lp - old_lp) * adv).mean()
    return mean_loss / len(iter_replays), mean_kl / len(iter_replays)


def conjugate_gradient(Ax, b, num_iterations=10, tol=1e-10):
    x = torch.zeros_like(b)
    r = b.clone()
    pdir = b.clone()
    rdotr = torch.dot(r, r)
    for _ in range(num_iterations):
        if rdotr < tol:
            break
        ap = Ax(pdir)
        alpha = rdotr / torch.dot(pdir, ap)
        x = x + alpha * pdir
        r = r - alpha * ap
        new_rdotr = torch.dot(r, r)
        pdir = r + (new_rdotr / rdotr) * pdir
        rdotr = new_rdotr
    return x


def meta_optimize_trpo(cfg, p, baseline, iter_replays, iter_policies):
    """Reference rl.py:409-438; mutates nothing, returns new params."""
    plist = params_list(p)
    old_loss, old_kl = meta_surrogate_loss(iter_replays, iter_policies, p,
                                           baseline, cfg)
    grad = torch.autograd.grad(old_loss, plist, retain_graph=True)
    grad = torch.cat([g.detach().reshape(-1) for g in grad])

    # cherry trpo.hessian_vector_product(old_kl, params, damping=1e-5)
    kl_grad = torch.autograd.grad(old_kl, plist, create_graph=True)
    kl_grad_flat = torch.cat([g.reshape(-1) for g in kl_grad])

    def Fvp(v):
        prod = torch.dot(kl_grad_flat, v)
        hv = torch.autograd.grad(prod, plist, retain_graph=True)
        return torch.cat([g.detach().reshape(-1)
                          for g in hv]) + 1e-5 * v

    step = conjugate_gradient(Fvp, grad)
    shs = 0.5 * torch.dot(step, Fvp(step))
    step = step / torch.sqrt(shs / cfg["max_kl"])
    old_loss = old_loss.detach()

    # unflatten the step
    steps = []
    off = 0
    for q in plist:
        steps.append(step[off:off + q.numel()].view_as(q))
        off += q.numel()

    for ls_step in range(cfg["ls_max_steps"]):
        stepsize = cfg["backtrack_factor"] ** ls_step * cfg["outer_lr"]
        cand = from_list([
            (q - stepsize * u).detach().requires_grad_(True)
            for q, u in zip(plist, steps)])
        new_loss, kl = meta_surrogate_loss(iter_replays, iter_policies,
                                           cand, baseline, cfg)
        if new_loss.item() < old_loss.item() and kl.item() < cfg["max_kl"]:
            return cand
    return p


# ---------------------------------------------------------------------------
# VPG (rl.py:208-254): A2C loss on UN-normalized advantages
# ---------------------------------------------------------------------------

def vpg_a2c_loss(ep, p, baseline, gamma, tau, anil=False,
                 body_detach=False):
    log_probs = policy_log_prob(p, ep["states"], ep["actions"], anil,
                                body_detach)
    adv = compute_advantages(baseline, tau, gamma, ep["rewards"],
                             ep["dones"], ep["states"], ep["next_states"])
    return -(log_probs * adv).mean()


def fast_adapt_vpg(p, goal, baseline, cfg, gen, second_order=True):
    """Reference fast_adapt_vpg (rl.py:229-254): inner SGD on the A2C
    loss, differentiable query loss for the Adam outer step."""
    anil = bool(cfg.get("anil", False))
    cur = p
    for _ in range(cfg["adapt_steps"]):
        support = collect_episodes(cur, goal, cfg["adapt_batch_size"],
                                   cfg["max_path_length"], gen, anil)
        loss = vpg_a2c_loss(support, cur, baseline, cfg["gamma"],
                            cfg["tau"], anil=anil, body_detach=anil)
        grads = torch.autograd.grad(loss, inner_params(cur, anil),
                                    retain_graph=second_order,
                                    create_graph=second_order)
        cur = inner_update(cur, grads, cfg["inner_lr"], anil)
    query = collect_episodes(cur, goal, cfg["adapt_batch_size"],
                             cfg["max_path_length"], gen, anil)
    valid_loss = vpg_a2c_loss(query, cur, baseline, cfg["gamma"],
                              cfg["tau"], anil=anil)
    return valid_loss, cur, episode_reward(query)


# ---------------------------------------------------------------------------
# PPO (rl.py:264-316)
# ---------------------------------------------------------------------------

def ppo_clip_loss(new_lp, old_lp, adv, clip):
    ratio = torch.exp(new_lp - old_lp)
    clipped = torch.clamp(ratio, 1 - clip, 1 + clip) * adv
    return -torch.min(ratio * adv, clipped).mean()


def fast_adapt_ppo(p, goal, baseline, cfg, gen, second_order=True):
    """-> (differentiable valid_loss, adapted params, query reward)."""
    anil = bool(cfg.get("anil", False))
    cur = p
    for _ in range(cfg["adapt_steps"]):
        support = collect_episodes(cur, goal, cfg["adapt_batch_size"],
                                   cfg["max_path_length"], gen, anil)
        adv = compute_advantages(baseline, cfg["tau"], cfg["gamma"],
                                 support["rewards"], support["dones"],
                                 support["states"], support["next_states"])
        adv = ch_normalize(adv).detach()
        with torch.no_grad():
            old_lp = policy_log_prob(cur, support["states"],
                                     support["actions"], anil)
        for _ in range(cfg["ppo_epochs"]):
            new_lp = policy_log_prob(cur, support["states"],
                                     support["actions"], anil,
                                     body_detach=anil)
            loss = ppo_clip_loss(new_lp, old_lp, adv,
                                 cfg["ppo_clip_ratio"])
            grads = torch.autograd.grad(loss, inner_params(cur, anil),
                                        retain_graph=second_order,
                                        create_graph=second_order)
            cur = inner_update(cur, grads, cfg["inner_lr"], anil)

    query = collect_episodes(cur, goal, cfg["adapt_batch_size"],
                             cfg["max_path_length"], gen, anil)
    adv = compute_advantages(baseline, cfg["tau"], cfg["gamma"],
                             query["rewards"], query["dones"],
                             query["states"], query["next_states"])
    adv = ch_normalize(adv).detach()
    with torch.no_grad():
        old_lp = policy_log_prob(cur, query["states"], query["actions"],
                                 anil)
    new_lp = policy_log_prob(cur, query["states"], query["actions"], anil)
    valid_loss = ppo_clip_loss(new_lp, old_lp, adv, cfg["ppo_clip_ratio"])
    return valid_loss, cur, episode_reward(query)


# ---------------------------------------------------------------------------
# Training loops (rl/maml_trpo.py:82-153, rl/maml_ppo.py:81-149) + eval
# ---------------------------------------------------------------------------

def evaluate(algo: str, p, baseline, cfg, rng, gen, n_tasks: int) -> float:
    """Reference evaluate (rl.py:142-196): adapt on each fresh task, then
    mean query reward over tasks."""
    anil = bool(cfg.get("anil", False))
    rewards = []
    for goal in sample_tasks(rng, n_tasks):
        if algo == "trpo":
            adapted, _, _ = fast_adapt_trpo(p, goal, baseline, cfg, gen)
        elif algo == "vpg":
            _, adapted, _ = fast_adapt_vpg(p, goal, baseline, cfg, gen,
                                           second_order=False)
            adapted = {k: v.detach() for k, v in adapted.items()}
        else:
            _, adapted, _ = fast_adapt_ppo(p, goal, baseline, cfg, gen,
                                           second_order=False)
            adapted = {k: v.detach() for k, v in adapted.items()}
        query = collect_episodes(adapted, goal, cfg["adapt_batch_size"],
                                 cfg["max_path_length"], gen, anil)
        rewards.append(episode_reward(query))
    return float(np.mean(rewards))


def make_baseline(cfg: dict) -> LinearValue:
    """The reference constructs ``LinearValue(env.state_size,
    env.action_size)`` (rl/maml_trpo.py:85 etc.) — cherry's second
    positional parameter is ``reg``, so the reference actually runs with
    reg = action dim (2.0 on Particles2D), not cherry's 1e-5 default.
    Reproduced here; override via cfg["value_reg"]."""
    return LinearValue(2, reg=float(cfg.get("value_reg", 2.0)))


def train_maml_trpo(cfg: dict, seed: int, log_every: int = 5):
    """-> (final meta-test reward, pre-training meta-test reward)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    p = init_policy(gen)
    baseline = make_baseline(cfg)

    def paired_eval(params):
        # Same eval task draws + rollout seeds pre and post (cf. the jax
        # side's shared eval_key) — the difference isolates training.
        return evaluate("trpo", params, baseline, cfg,
                        np.random.default_rng(seed + 1000),
                        torch.Generator().manual_seed(seed + 1000),
                        cfg["n_eval_tasks"])

    pre = paired_eval(p)
    for it in range(cfg["num_iterations"]):
        goals = sample_tasks(rng, cfg["meta_batch_size"])
        iter_replays, iter_policies, rews = [], [], []
        for goal in goals:
            adapted, replay, rew = fast_adapt_trpo(p, goal, baseline, cfg,
                                                   gen)
            iter_replays.append(replay)
            iter_policies.append(adapted)
            rews.append(rew)
        p = meta_optimize_trpo(cfg, p, baseline, iter_replays,
                               iter_policies)
        if (it + 1) % log_every == 0:
            print(f"torch trpo iter {it + 1}/{cfg['num_iterations']} "
                  f"adapt_reward {np.mean(rews):.3f}", flush=True)
    post = paired_eval(p)
    return post, pre


def train_maml_adam(algo: str, cfg: dict, seed: int, log_every: int = 5):
    """MAML-PPO / MAML-VPG training loop: Adam over the mean
    differentiable query loss (reference rl/maml_ppo.py:81-149; the VPG
    variant swaps fast_adapt_ppo for fast_adapt_vpg)."""
    fast_adapt = fast_adapt_vpg if algo == "vpg" else fast_adapt_ppo
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    p = init_policy(gen)
    baseline = make_baseline(cfg)
    opt = torch.optim.Adam(params_list(p), lr=cfg["outer_lr"])

    def paired_eval(params):
        return evaluate(algo, params, baseline, cfg,
                        np.random.default_rng(seed + 1000),
                        torch.Generator().manual_seed(seed + 1000),
                        cfg["n_eval_tasks"])

    pre = paired_eval(p)
    for it in range(cfg["num_iterations"]):
        goals = sample_tasks(rng, cfg["meta_batch_size"])
        opt.zero_grad()
        iter_loss = 0.0
        rews = []
        for goal in goals:
            valid_loss, _, rew = fast_adapt(p, goal, baseline, cfg, gen)
            iter_loss = iter_loss + valid_loss
            rews.append(rew)
        (iter_loss / cfg["meta_batch_size"]).backward()
        opt.step()
        if (it + 1) % log_every == 0:
            print(f"torch {algo} iter {it + 1}/{cfg['num_iterations']} "
                  f"adapt_reward {np.mean(rews):.3f}", flush=True)
    post = paired_eval(p)
    return post, pre


def train_maml_ppo(cfg: dict, seed: int, log_every: int = 5):
    return train_maml_adam("ppo", cfg, seed, log_every)


def train_maml_vpg(cfg: dict, seed: int, log_every: int = 5):
    return train_maml_adam("vpg", cfg, seed, log_every)
