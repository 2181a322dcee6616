"""The port's CUDA kernels vs their plain twins, on the card.

Needs an NVIDIA Hopper card; skips without one. This file imports
neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))
import chip_smoke  # noqa: E402  (the float64 reference meta-gradient)
from exploring_meta_tpu_torch.cuda import cnn4_cuda as tc
from exploring_meta_tpu_torch.cuda import gae_cuda as gc
from exploring_meta_tpu_torch.models.cnn4 import init_cnn4, omniglot_spec
from exploring_meta_tpu_torch.models.layers import set_precision
from exploring_meta_tpu_torch.serve import VisionServer


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    set_precision("highest")
    return torch.device("cuda")


def _block_inputs(rng, dev, b, n, h, ci, co=64):
    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)
    x = t(rng.normal(size=(b, n, h, h, ci)))
    w = t(rng.normal(size=(b, 3, 3, ci, co)) * (2.0 / (9 * ci)) ** 0.5)
    p = [t(rng.normal(size=(b, co)) * 0.1),
         t(rng.uniform(0.1, 1.0, size=(b, co))),
         t(rng.normal(size=(b, co)) * 0.1)]
    # no cotangent where the ReLU input sits within 1e-3 of its kink:
    # there f32 rounding may decide the mask differently on the two sides
    xh, _, s, be = tc.bn_stats_plain(x, w, *p)
    ho = tc.out_hw(h)
    g = t(rng.normal(size=(b, n, ho, ho, co))) * ((xh * s + be).abs() > 1e-3)
    return x, w, p, g


@pytest.mark.cuda
@pytest.mark.parametrize("h,ci", [(28, 1), (14, 64), (7, 64), (4, 64)])
def test_kernels_match_plain_twins(cuda_device, h, ci):
    x, w, p, g = _block_inputs(np.random.default_rng(h), cuda_device,
                               4, 25, h, ci)
    torch.testing.assert_close(tc.block_fwd(x, w, *p),
                               tc.block_fwd_plain(x, w, *p),
                               rtol=1e-4, atol=1e-4)
    got = tc.block_bwd_params(x, w, *p, g)
    want = tc.block_bwd_params_plain(x, w, *p, g)
    for i, (a, b) in enumerate(zip(got, want)):
        if i != 2:      # db = sum(dy) is zero up to rounding on both sides
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(tc.block_bwd_input(got[0], w, h, h),
                               tc.block_bwd_input_plain(got[0], w, h, h),
                               rtol=1e-4, atol=1e-4)


# (tasks, images per task, H, Ci) at which the tiled kernels are held:
# the four served block shapes at N = 25, the query forward at N = 15 (M =
# 735 at block 2 leaves a ragged last tile), B = 1 with N = 1, and N = 128
# and N = 400 at block 1 (400: past the 295 images per task that
# bwd_params took when it held a task's channel in shared memory)
_BLOCKS = [(28, 1), (14, 64), (7, 64), (4, 64)]
_TILED_SHAPES = ([(2, 25, h, ci) for h, ci in _BLOCKS]
                 + [(2, 15, h, ci) for h, ci in _BLOCKS]
                 + [(1, 1, h, ci) for h, ci in _BLOCKS] + [(2, 128, 28, 1),
                                                          (2, 400, 28, 1)])
# db = sum(dy) is zero in exact arithmetic: held relative to sum(|dy|) per
# (task, channel), as chip_smoke.DB_TOL
_DB_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _held(got, want, tol):
    """|got - want| <= tol * max|want| + tol * |want| (chip_smoke.TOL)."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    lim = tol * want.abs().max() + tol * want.abs()
    assert ((got - want).abs() <= lim).all(), float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,n,h,ci", _TILED_SHAPES)
def test_tiled_kernels_match_plain_twins(cuda_device, b, n, h, ci, dtype,
                                         tol):
    """The forward, the parameter gradients and the input gradient against
    their twins, and each twice with bitwise equal results."""
    rng = np.random.default_rng(n * h + ci)
    x, w, p, g = _block_inputs(rng, cuda_device, b, n, h, ci)
    x, w, p = x.to(dtype), w.to(dtype), [t.to(dtype) for t in p]
    # the cotangent's mask at the kink, again from the inputs as cast
    xh, _, s, be = tc.bn_stats_plain(x, w, *p)
    g = (g * ((xh * s + be).abs() > 1e-3)).to(dtype)
    got = tc.block_fwd(x, w, *p)
    _held(got, tc.block_fwd_plain(x, w, *p), tol)
    assert torch.equal(got, tc.block_fwd(x, w, *p))
    got = tc.block_bwd_params(x, w, *p, g)
    want = tc.block_bwd_params_plain(x, w, *p, g)
    for i, (a, c) in enumerate(zip(got, want)):
        if i == 2:
            lim = _DB_TOL[dtype] * want[0].abs().sum(dim=(1, 2, 3))
            assert ((a.float() - c.float()).abs() <= lim).all()
        else:
            _held(a, c, tol)
    again = tc.block_bwd_params(x, w, *p, g)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    ho = tc.out_hw(h)
    dy = torch.tensor(rng.normal(size=(b, n, ho, ho, 64)),
                      dtype=torch.float32, device=cuda_device)
    got = tc.block_bwd_input(dy, w, h, h)
    _held(got, tc.block_bwd_input_plain(dy, w, h, h), tol)
    assert torch.equal(got, tc.block_bwd_input(dy, w, h, h))


# The bf16 tensor-core kernels (the conv of cnn4_block_fwd and of
# cnn4_block_bwd_params, its dw GEMM, and the dx GEMMs of
# cnn4_block_bwd_input) at every block shape, at one request, a bucket of
# 8 and a served batch, from one image a task to 400
_BF16_SHAPES = [(b, n, h, ci) for h, ci in _BLOCKS for b in (1, 8, 64)
                for n in (1, 5, 25, 128, 400)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,h,ci", _BF16_SHAPES)
def test_bf16_tensor_core_kernels_carry_f32_products(cuda_device, b, n, h,
                                                     ci):
    """bf16: every output of the forward and of bwd_params but db, and
    bwd_input's dx from bwd_params' dy, within one bf16 ulp plus f32 noise
    of its twin taken in float64, equal to it in all but
    cnn4_cuda.BF16_SHARE of its elements (chip_smoke.held_bf16; over ~10^5
    positions an f32 twin's own rounding flips as many), the f32 dy within
    float32's 1e-4, db by its magnitude; two calls bitwise equal. The f32
    kernels at the same inputs within 1e-4 (chip_smoke.TOL)."""
    rng = np.random.default_rng(b * 1009 + n * h + ci)
    x, w, p, g = _block_inputs(rng, cuda_device, b, n, h, ci)
    _held(tc.block_fwd(x, w, *p), tc.block_fwd_plain(x, w, *p), 1e-4)
    for i, (a, c) in enumerate(zip(tc.block_bwd_params(x, w, *p, g),
                                   tc.block_bwd_params_plain(x, w, *p, g))):
        if i != 2:
            _held(a, c, 1e-4)
    x, w, p = x.to(torch.bfloat16), w.to(torch.bfloat16), [
        t.to(torch.bfloat16) for t in p]
    xh, _, s, be = tc.bn_stats_plain(x, w, *p)
    g = (g * ((xh * s + be).abs() > 1e-3)).to(torch.bfloat16)
    what = f"B {b} N {n} H {h}"
    f64 = torch.float64
    got = tc.block_fwd(x, w, *p)
    chip_smoke.held_bf16(tc, got, tc.block_fwd_plain(x, w, *p, acc=f64),
                         f"fwd {what}")
    assert torch.equal(got, tc.block_fwd(x, w, *p))
    got = tc.block_bwd_params(x, w, *p, g)
    want = tc.block_bwd_params_plain(x, w, *p, g)
    _held(got[0], want[0], 1e-4)
    lim = _DB_TOL[torch.bfloat16] * want[0].abs().sum(dim=(1, 2, 3))
    assert ((got[2].float() - want[2].float()).abs() <= lim).all()
    want = tc.block_bwd_params_plain(x, w, *p, g, acc=f64)
    for i, name in ((1, "dw"), (3, "dscale"), (4, "dbias")):
        chip_smoke.held_bf16(tc, got[i], want[i], f"{name} {what}")
    again = tc.block_bwd_params(x, w, *p, g)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    dx = tc.block_bwd_input(got[0], w, h, h)
    assert dx.dtype == torch.bfloat16
    chip_smoke.held_bf16(tc, dx, tc.block_bwd_input_plain(
        got[0], w, h, h, acc=f64), f"dx {what}")
    assert torch.equal(dx, tc.block_bwd_input(got[0], w, h, h))


@pytest.mark.cuda
def test_bf16_served_batch_takes_dx_on_the_tensor_cores(cuda_device):
    """A bf16 served batch, its eager first call and a replay, each under
    the profiler: three launches of bwd_input_tc_kernel, none of the f32
    bwd_input_kernel; the wrapper's counts 8 / 4 / 3."""
    from torch.profiler import ProfilerActivity, profile

    def dx_kernels(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        return {k: sum(1 for n in names if k in n)
                for k in ("bwd_input_tc_kernel", "bwd_input_kernel")}

    spec = omniglot_spec(ways=5)
    params = init_cnn4(torch.Generator().manual_seed(0), spec,
                       device=cuda_device)
    server = VisionServer(spec, params, inner_lr=0.5, adapt_steps=1,
                          compute_dtype=torch.bfloat16)
    sx, sy, qx = _vision_requests(cuda_device, 8)
    tc.reset_launch_counts()
    eager = dx_kernels(lambda: server.batch(sx, sy, qx))
    assert tc.launch_counts() == {"cnn4_block_fwd": 8,
                                  "cnn4_block_bwd_params": 4,
                                  "cnn4_block_bwd_input": 3,
                                  "cnn4_block_double_backward": 0}
    replay = dx_kernels(lambda: server.batch(sx, sy, qx))
    want = {"bwd_input_tc_kernel": 3, "bwd_input_kernel": 0}
    assert eager == want and replay == want, (eager, replay)


@pytest.mark.cuda
def test_bf16_kernels_run_on_every_device(cuda_device):
    """A server mesh runs its shards on several cards in one process: the
    bf16 forward, bwd_params (whose dw kernel needs more than 48 KB of
    shared memory, an attribute of each device's context) and bwd_input on
    every visible card in turn, each held as above and equal to the first
    card's result bit for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ins = tc.block_inputs(gen, 8, 25, 14, 64, 64, torch.bfloat16)
    first = None
    for d in range(torch.cuda.device_count()):
        on = [t.to(f"cuda:{d}") for t in ins]
        got = (tc.block_fwd(*on[:5]),) + tc.block_bwd_params(*on)
        got += (tc.block_bwd_input(got[1], on[1], 14, 14),)
        want = tc.block_bwd_params_plain(*on, acc=torch.float64)
        chip_smoke.held_bf16(tc, got[0], tc.block_fwd_plain(
            *on[:5], acc=torch.float64), f"fwd on cuda:{d}")
        chip_smoke.held_bf16(tc, got[2], want[1], f"dw on cuda:{d}")
        chip_smoke.held_bf16(tc, got[-1], tc.block_bwd_input_plain(
            got[1], on[1], 14, 14, acc=torch.float64), f"dx on cuda:{d}")
        got = [t.cpu() for t in got]
        if first is None:
            first = got
        assert all(torch.equal(a, c) for a, c in zip(got, first)), d


@pytest.mark.cuda
def test_bf16_server_mesh_on_every_device(cuda_device):
    """A bf16 vision server with a shard on every visible card: its first
    batch (eager on each card, then captured) gives finite probabilities,
    and its replay gives them again bit for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    from exploring_meta_tpu_torch.parallel.mesh import make_task_mesh
    spec = omniglot_spec(ways=5)
    params = init_cnn4(torch.Generator().manual_seed(0), spec,
                       device=cuda_device)
    server = VisionServer(spec, params, inner_lr=0.5, adapt_steps=1,
                          compute_dtype=torch.bfloat16,
                          mesh=make_task_mesh())
    n = 2 * torch.cuda.device_count()
    rng = np.random.default_rng(0)
    sx = torch.tensor(rng.normal(size=(n, 25, 28, 28, 1)),
                      dtype=torch.float32)
    sy = torch.arange(5).repeat(5).expand(n, -1)
    preds, probs = server.batch(sx, sy, sx[:, :15])
    again = server.batch(sx, sy, sx[:, :15])
    torch.cuda.synchronize()
    assert preds.shape == (n, 15) and torch.isfinite(probs).all()
    assert torch.equal(preds, again[0]) and torch.equal(probs, again[1])


@pytest.mark.cuda
def test_served_batch_runs_every_kernel(cuda_device):
    spec = omniglot_spec(ways=5)
    params = init_cnn4(torch.Generator().manual_seed(0), spec,
                       device=cuda_device)
    server = VisionServer(spec, params, inner_lr=0.5, adapt_steps=1)
    rng = np.random.default_rng(0)
    sx = torch.tensor(rng.normal(size=(3, 25, 28, 28, 1)),
                      dtype=torch.float32)
    sy = torch.arange(5).repeat(5).expand(3, -1)
    tc.reset_launch_counts()
    preds, probs = server.batch(sx, sy, sx[:, :15])
    torch.cuda.synchronize()
    assert tc.launch_counts() == {"cnn4_block_fwd": 8,
                                  "cnn4_block_bwd_params": 4,
                                  "cnn4_block_bwd_input": 3,
                                  "cnn4_block_double_backward": 0}
    assert torch.isfinite(probs).all() and preds.shape == (3, 15)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(20, 100, 20), (64, 50, 10), (40, 150, 20),
                                   (100, 400), (100,), (1,), (129,),
                                   (4, 129, 5), (1000,)])
@pytest.mark.parametrize("dones", ["mid", "zeros", "ones"])
def test_sweep_kernels_match_plain_twins(cuda_device, shape, dones):
    """The main path's shape, the reference's maml_trpo scale, the [T,
    lanes] form and one column; T = 1, one step past a 128-step slab and a
    long T. Each kernel twice, with bitwise equal results."""
    rng = np.random.default_rng(len(shape))
    r, v = (torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                         device=cuda_device) for _ in range(2))
    d = torch.tensor(rng.uniform(size=shape) < 0.1 if dones == "mid"
                     else np.full(shape, dones == "ones"),
                     dtype=torch.float32, device=cuda_device)
    gc.reset_launch_counts()
    for got, again, want in (
            (gc.gae_sweep(0.99, 0.95, r, d, v),
             gc.gae_sweep(0.99, 0.95, r, d, v),
             gc.gae_plain(0.99, 0.95, r, d, v)),
            (gc.discount_sweep(0.99, r, d), gc.discount_sweep(0.99, r, d),
             gc.discount_plain(0.99, r, d))):
        # float32 terms, each rounded once, whose weights sum to at most
        # 1 / (1 - 0.99) = 100 whatever T
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
        assert torch.equal(got, again)
    assert gc.launch_counts() == {"gae_sweep": 2, "discount_sweep": 2}


@pytest.mark.cuda
def test_sweep_autograd_is_the_plain_vjp(cuda_device):
    rng = np.random.default_rng(0)
    r, d, v, g = (torch.tensor(a, dtype=torch.float32, device=cuda_device)
                  for a in (rng.normal(size=(3, 40, 5)),
                            rng.uniform(size=(3, 40, 5)) < 0.1,
                            rng.normal(size=(3, 40, 5)),
                            rng.normal(size=(3, 40, 5))))

    def grads(fn):
        ins = [x.clone().requires_grad_() for x in (r, v)]
        return torch.autograd.grad(fn(ins[0], d, ins[1]), ins, g)

    got = grads(lambda r, d, v: gc.gae_sweep(0.99, 0.95, r, d, v))
    want = grads(lambda r, d, v: gc.gae_plain(0.99, 0.95, r, d, v))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    rr = r.clone().requires_grad_()
    (a,) = torch.autograd.grad(gc.discount_sweep(0.99, rr, d), rr, g)
    (b,) = torch.autograd.grad(gc.discount_plain(0.99, rr, d), rr, g)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_trpo_iteration_runs_the_sweeps(cuda_device, tmp_path):
    from exploring_meta_tpu_torch.trainers.rl import RLTrainer
    from exploring_meta_tpu_torch.utils.config import RLScriptConfig
    cfg = RLScriptConfig(num_iterations=1, meta_batch_size=4,
                         adapt_batch_size=5, max_path_length=20,
                         n_eval_tasks=2)
    gc.reset_launch_counts()
    final = RLTrainer(cfg, path=str(tmp_path) + "/").run()
    counts = gc.launch_counts()
    # collection 3 + two surrogate evaluations or more 2 each, + meta-test 3
    assert counts["gae_sweep"] >= 10 and counts["discount_sweep"] >= 10
    assert np.isfinite(final["mean_reward"])


def _policy_supports(n, dev, seed=1):
    """A DiagNormalPolicy (100, 100), its params (CPU) and ``n`` support
    batches of 10 episodes x 50 steps collected on ``dev``."""
    from exploring_meta_tpu_torch.envs.particles2d import Particles2D
    from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
    from exploring_meta_tpu_torch.rl.rollout import make_rollout
    env = Particles2D()
    policy = DiagNormalPolicy(2, 2)
    params = policy.init(torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator(device=dev).manual_seed(seed)
    roll = make_rollout(env, policy.sample, 10, 50)
    return policy, params, roll(_to(params, dev), env.sample_tasks(gen, n),
                                gen)


def _to(tree, dev):
    from exploring_meta_tpu_torch.utils.tree import tree_map
    return tree_map(lambda t: t.to(dev), tree)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["vpg", "ppo", "trpo"])
def test_policy_server_runs_the_sweeps_and_matches_the_cpu(cuda_device,
                                                           algo):
    from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig
    from exploring_meta_tpu_torch.serve import PolicyServer
    policy, params, stack = _policy_supports(8, cuda_device)
    cfg = RLConfig(**chip_smoke.SERVE_RL_CFG)
    gc.reset_launch_counts()
    server = PolicyServer(policy, params, cfg, algo=algo)
    got, fits = chip_smoke.with_baseline_fits(
        lambda: server.adapt_batched(stack))
    torch.cuda.synchronize()
    assert gc.launch_counts() == {"gae_sweep": 1, "discount_sweep": 1}
    cpu = PolicyServer(policy, params, cfg, algo=algo, device="cpu")
    # on the card's baseline fits (chip_smoke.ADAPT_TOL says why)
    want, _ = chip_smoke.with_baseline_fits(
        lambda: cpu.adapt_batched(stack.map(torch.Tensor.cpu)), fits)
    chip_smoke.tree_close(torch, got, want, chip_smoke.ADAPT_TOL,
                          f"{algo} card vs CPU")


@pytest.mark.cuda
@pytest.mark.parametrize("algo,anil", [("ppo", False), ("vpg", True)])
def test_adam_iteration_runs_the_sweeps(cuda_device, tmp_path, algo, anil):
    from exploring_meta_tpu_torch.trainers.rl import RLTrainer
    from exploring_meta_tpu_torch.utils.config import RLScriptConfig
    # Adam at the reference maml_ppo's 0.01: at the default 0.1 (TRPO's
    # step size) this small run diverges to NaN within 3 iterations, as
    # the JAX trainer's does
    cfg = RLScriptConfig(num_iterations=2, meta_batch_size=4,
                         adapt_batch_size=5, max_path_length=20,
                         n_eval_tasks=2, outer_lr=0.01)
    gc.reset_launch_counts()
    final = RLTrainer(cfg, algo=algo, anil=anil,
                      path=str(tmp_path) + "/").run()
    # per iteration: one support batch and the query; the meta-test too
    assert gc.launch_counts() == {"gae_sweep": 6, "discount_sweep": 6}
    assert np.isfinite(final["mean_reward"])


@pytest.mark.cuda
def test_ppo_replay_meta_gradient_card_vs_cpu(cuda_device):
    from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig
    from exploring_meta_tpu_torch.rl.replay_meta import make_replay_meta_loss
    from exploring_meta_tpu_torch.rl.rollout import stack_trajectories
    policy, params, support = _policy_supports(4, cuda_device)
    _, _, query = _policy_supports(4, cuda_device, seed=2)
    replays = stack_trajectories([support, query], dim=1)
    cfg = RLConfig(inner_lr=0.05, adapt_batch_size=10, max_path_length=50)
    # held on the card's baseline fits (chip_smoke.ADAPT_TOL says why),
    # within chip_smoke.REPLAY_*; fails inside on any disagreement
    res = chip_smoke.ppo_replay_card_vs_cpu(
        torch, make_replay_meta_loss("ppo", policy, cfg), params, replays,
        cfg.ppo_clip_ratio)
    assert res["grad_max_rel_err"] <= res["grad_tol"]


def _meta_grad(impl, dev, dtype=None, tasks=4, steps=1):
    """One full-width second-order meta-gradient (5-way 5-shot, inner_lr
    0.05) -> (loss, {leaf path: grad f64 on the CPU}, kernel calls, the
    fused blocks' ReLU masks, the base params, data, labels)."""
    from exploring_meta_tpu_torch.adapt.maml import cast_compute
    from exploring_meta_tpu_torch.adapt.vision import make_vision_fast_adapt
    from exploring_meta_tpu_torch.models.layers import (
        get_conv_impl, set_conv_impl,
    )
    from exploring_meta_tpu_torch.utils.tree import (
        tree_items, tree_leaves, tree_map, tree_unflatten,
    )
    spec = omniglot_spec(5)
    rng = np.random.default_rng(0)
    data = torch.tensor(rng.uniform(size=(tasks, 50, 28, 28, 1)),
                        dtype=torch.float32, device=dev)
    labels = torch.arange(5, device=dev).repeat_interleave(10).expand(
        tasks, -1)
    base = init_cnn4(torch.Generator().manual_seed(0), spec, device="cpu")
    params = tree_map(lambda t: t.to(dev).requires_grad_(), base)
    fa = make_vision_fast_adapt(spec, 0.05, steps, 5, 5)
    if dtype is not None:
        fa = cast_compute(fa, dtype)
    prev = get_conv_impl()
    set_conv_impl(impl)
    try:
        tc.reset_launch_counts()

        def run():
            loss = fa(params, data, labels).loss.mean()
            return loss, torch.autograd.grad(loss, tree_leaves(params))
        (loss, grads), masks = chip_smoke.recorded_masks(tc, run)
        torch.cuda.synchronize()
    finally:
        set_conv_impl(prev)
    grads = {k: g.double().cpu()
             for k, g in tree_items(tree_unflatten(params, grads))}
    return (float(loss.detach()), grads, tc.launch_counts(), masks, base,
            data, labels)


@pytest.mark.cuda
def test_second_order_fused_matches_direct_f32(cuda_device):
    """Against a float64 plain reference on the kernels' own ReLU masks,
    rtol 3e-4 / atol 3e-5 x max|grad| per leaf; against the direct path
    (cuDNN), which makes its own masks, within 1e-2 x max|grad| (a ReLU
    input within f32 rounding of the kink may fall on either side,
    chip_smoke.py); the conv-bias grads (zero in exact arithmetic) within
    1e-4 of the block's BN-bias grads."""
    loss, got, counts, masks, base, data, labels = _meta_grad("fused",
                                                              cuda_device)
    assert counts == {"cnn4_block_fwd": 8, "cnn4_block_bwd_params": 12,
                      "cnn4_block_bwd_input": 9,
                      "cnn4_block_double_backward": 4}
    ref_loss, ref = chip_smoke.reference_meta_grad(torch, base, data,
                                                   labels, masks, 0.05)
    direct_loss, direct, direct_counts, *_ = _meta_grad("direct",
                                                        cuda_device)
    assert not any(direct_counts.values())
    for want_loss, want, rtol, atol in ((ref_loss, ref, 3e-4, 3e-5),
                                        (direct_loss, direct, 0.0, 1e-2)):
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
        for key, w in want.items():
            if key.endswith("conv/b"):
                scale = float(want[key[:-6] + "bn/bias"].abs().max())
                assert float(got[key].abs().max()) <= 1e-4 * scale, key
                continue
            torch.testing.assert_close(got[key], w, rtol=rtol,
                                       atol=atol * float(w.abs().max()),
                                       msg=f"{key} (atol {atol})")


def _rel_l2(grads, ref):
    """Distance of a meta-gradient from ``ref`` over every leaf but the
    conv biases (zero in exact arithmetic), relative to |ref|."""
    keys = [k for k in ref if not k.endswith("conv/b")]
    d = torch.cat([(grads[k] - ref[k]).reshape(-1) for k in keys])
    return float(d.norm() / torch.cat([ref[k].reshape(-1) for k in keys])
                 .norm())


@pytest.mark.cuda
def test_second_order_fused_bf16_near_f32(cuda_device):
    """bf16 through cast_compute on the kernels, every call in bf16 on the
    card: the loss within 2e-2 of f32's. A bf16 meta-gradient lies tens
    of per cent (relative L2) from the f32 one on either path, the kernels
    and cuDNN alike (chip_smoke.py, "bf16_rel_l2"), so it is held against
    cuDNN's bf16 meta-gradient: no farther from f32 than 1.5x cuDNN's
    distance."""
    loss, grads, *_ = _meta_grad("fused", cuda_device)
    bloss, bgrads, counts, *_ = _meta_grad("fused", cuda_device,
                                           torch.bfloat16)
    dgrads = _meta_grad("direct", cuda_device, torch.bfloat16)[1]
    assert counts == {"cnn4_block_fwd": 8, "cnn4_block_bwd_params": 12,
                      "cnn4_block_bwd_input": 9,
                      "cnn4_block_double_backward": 4}
    assert abs(bloss - loss) <= 2e-2 * abs(loss)
    assert all(bool(torch.isfinite(g).all()) for g in bgrads.values())
    assert _rel_l2(bgrads, grads) <= 1.5 * _rel_l2(dgrads, grads)


@pytest.mark.cuda
def test_meta_step_kernel_counts(cuda_device):
    """One Adam meta-step at full width: 8 / 12 / 9 calls; a meta-eval
    (first order, no query graph): 8 / 4 / 3; a second inner step adds a
    support forward (4), its second-order backward (4 + 3) and that
    forward's backward in the outer pass (4 + 3)."""
    from exploring_meta_tpu_torch.adapt.maml import (
        adam, make_meta_eval, make_meta_step,
    )
    from exploring_meta_tpu_torch.adapt.vision import make_vision_fast_adapt
    from exploring_meta_tpu_torch.utils.tree import tree_map
    spec = omniglot_spec(5)
    params = tree_map(lambda t: t.requires_grad_(), init_cnn4(
        torch.Generator(device=cuda_device).manual_seed(1), spec))
    data = torch.rand(2, 50, 28, 28, 1, device=cuda_device)
    labels = torch.arange(5, device=cuda_device).repeat_interleave(10)
    labels = labels.expand(2, -1)
    fa = make_vision_fast_adapt(spec, 0.5, 1, 5, 5)
    tc.reset_launch_counts()
    _, _, m = make_meta_step(fa)(params, adam(params, 3e-3), data, labels)
    assert np.isfinite(float(m["loss"]))
    assert tc.launch_counts() == {"cnn4_block_fwd": 8,
                                  "cnn4_block_bwd_params": 12,
                                  "cnn4_block_bwd_input": 9,
                                  "cnn4_block_double_backward": 4}
    tc.reset_launch_counts()
    make_meta_eval(fa)(params, data, labels)
    assert tc.launch_counts() == {"cnn4_block_fwd": 8,
                                  "cnn4_block_bwd_params": 4,
                                  "cnn4_block_bwd_input": 3,
                                  "cnn4_block_double_backward": 0}
    counts = _meta_grad("fused", cuda_device, tasks=2, steps=2)[2]
    assert counts == {"cnn4_block_fwd": 12, "cnn4_block_bwd_params": 20,
                      "cnn4_block_bwd_input": 15,
                      "cnn4_block_double_backward": 8}


# The double backward (cnn4_block_double_bwd): the meta-training cell's
# B = 32, N = 25 at the four blocks, one task, and shapes off the 16-byte
# paths (Ci 3 and 8, Co 12 and 20), as (B, N, H, Ci, Co)
_DBL_SHAPES = ([(32, 25, h, ci, 64) for h, ci in _BLOCKS]
               + [(1, 25, h, ci, 64) for h, ci in _BLOCKS]
               + [(2, 3, 9, 3, 12), (3, 5, 14, 8, 20)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,n,h,ci,co", _DBL_SHAPES)
def test_double_backward_matches_its_twin(cuda_device, b, n, h, ci, co,
                                          dtype):
    """Every cotangent sent: the kernels' outputs against the float64
    twin's (f32 within 1e-4, bf16 within one bf16 ulp and BF16_SHARE,
    chip_smoke.double_bwd_held), twice bitwise equal, and each call on the
    kernel route."""
    gen = torch.Generator(device=cuda_device).manual_seed(b * n + h + ci)
    tc.reset_launch_counts()
    call, got, want, tie, _ = chip_smoke.double_bwd_case(tc, torch, gen, b,
                                                         n, h, ci, co, dtype)
    chip_smoke.double_bwd_held(tc, torch, got, want, tie,
                               str(dtype).split(".")[1], f"{b} {n} {h} {ci}")
    assert all(a is None or torch.equal(a, c) for a, c in zip(got, call()))
    assert tc.routes()["double_bwd_kernels"] == 2
    assert tc.routes()["double_bwd_plain"] == 0
    assert tc.launch_counts()["cnn4_block_double_backward"] == 2


@pytest.mark.cuda
def test_second_order_meta_gradient_replays_its_eager_call(cuda_device):
    """A full-width second-order meta-gradient (4 tasks, f32) captured in
    one CUDA graph: two replays give the eager call's meta-gradient bit for
    bit, and the four double backwards take the kernel route, eager and
    captured."""
    from exploring_meta_tpu_torch.adapt.vision import make_vision_fast_adapt
    from exploring_meta_tpu_torch.utils.tree import tree_leaves, tree_map
    spec = omniglot_spec(5)
    params = tree_map(lambda t: t.requires_grad_(), init_cnn4(
        torch.Generator(device=cuda_device).manual_seed(2), spec))
    data = torch.rand(4, 50, 28, 28, 1, device=cuda_device)
    labels = torch.arange(5, device=cuda_device).repeat_interleave(10)
    labels = labels.expand(4, -1)
    fa = make_vision_fast_adapt(spec, 0.05, 1, 5, 5)

    def meta_grad():
        loss = fa(params, data, labels).loss.mean()
        return torch.autograd.grad(loss, tree_leaves(params))

    tc.reset_launch_counts()
    eager = meta_grad()
    assert tc.routes()["double_bwd_kernels"] == 4
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        meta_grad()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    tc.reset_launch_counts()
    with torch.cuda.graph(graph):
        captured = meta_grad()
    assert tc.captured_routes()["double_bwd_kernels"] == 4
    assert tc.captured_counts()["cnn4_block_double_backward"] == 4
    assert not tc.routes()["double_bwd_kernels"]
    graph.replay()
    torch.cuda.synchronize()
    first = [t.clone() for t in captured]
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(eager, first))
    assert all(torch.equal(a, c) for a, c in zip(first, captured))


@pytest.mark.cuda
def test_first_order_kernels_unchanged_by_the_double_backward(cuda_device):
    """``csrc/cnn4_block.cu`` built whole and built without its
    double-backward section: the forward, ``bwd_params`` and ``bwd_input``
    give the same bits at the four blocks in f32 and bf16, at B = 32 and at
    B = 1 (the cluster route)."""
    from exploring_meta_tpu_torch.cuda import build
    from exploring_meta_tpu_torch.cuda import compare_cnn4 as cc
    from exploring_meta_tpu_torch.cuda.compare_sweeps import _compile
    with open(os.path.join(build.CSRC, tc._SOURCE)) as f:
        src = f.read()
    cut = src[:src.index("// " + "=" * 75 + "\n// cnn4_block_double_bwd")]
    first_order = cc._load(_compile("first_order", cut, "cuda_tests")[0])
    whole = cc._load(build.build(tc._SOURCE))
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    for dname in ("float32", "bfloat16"):
        for b, n in ((32, 25), (1, 10)):
            for h, ci in cc.BLOCKS:
                ins = cc.block_inputs(gen, b, n, h, ci, cc.DTYPES[dname][0])
                a = cc._run(cc._calls(first_order, dname, ins))
                c = cc._run(cc._calls(whole, dname, ins))
                for k in a:
                    assert all(torch.equal(u, v)
                               for u, v in zip(a[k], c[k])), (dname, b, h, k)


def _fused_run(kind, fuse, tmp_path, algo="trpo"):
    """A small trainer run of 4 iterations at ``fuse`` -> (final params
    {key: CPU tensor}, graph counts)."""
    from exploring_meta_tpu_torch.trainers.rl import RLTrainer
    from exploring_meta_tpu_torch.trainers.vision import VisionTrainer
    from exploring_meta_tpu_torch.utils import graphs
    from exploring_meta_tpu_torch.utils.config import (
        RLScriptConfig, VisionConfig,
    )
    path = str(tmp_path / f"{kind}_{algo}_{fuse}") + "/"
    graphs.reset_counts()
    if kind == "rl":
        cfg = RLScriptConfig(num_iterations=4, meta_batch_size=4,
                             adapt_batch_size=5, max_path_length=20,
                             n_eval_tasks=2, outer_lr=0.01, fuse=fuse)
        trainer = RLTrainer(cfg, algo=algo, path=path)
    else:
        cfg = VisionConfig(num_iterations=4, meta_batch_size=2, shots=1,
                           synthetic=True, fuse=fuse)
        trainer = VisionTrainer(cfg, path=path)
    trainer.run()
    with np.load(os.path.join(trainer.model_path, "model.npz")) as z:
        params = {k: torch.from_numpy(z[k]) for k in z.files}
    return params, dict(graphs.COUNTS)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,algo", [("rl", "trpo"), ("rl", "ppo"),
                                       ("vision", None)])
def test_fused_chunks_match_eager(cuda_device, tmp_path, kind, algo):
    """4 iterations at ``--fuse 3`` (the eager warm-up, one capture, three
    replays) against ``--fuse 1`` from the same seed: the Adam paths
    within 1e-5 of max|params|, TRPO within 2e-2 of the run's step (f32
    CG, ROADMAP Queue 3)."""
    got, counts = _fused_run(kind, 3, tmp_path, algo)
    want, eager_counts = _fused_run(kind, 1, tmp_path, algo)
    assert counts == {"captures": 1, "replays": 3}
    assert eager_counts == {"captures": 0, "replays": 0}
    top = max(float(w.abs().max()) for w in want.values())
    err = max(float((got[k] - w).abs().max()) for k, w in want.items())
    if algo == "trpo":
        from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
        from exploring_meta_tpu_torch.utils.tree import tree_items
        init = dict(tree_items(DiagNormalPolicy(2, 2).init(
            torch.Generator(device=cuda_device).manual_seed(42))))
        l2 = lambda a, b: sum(float((a[k].cpu() - b[k].cpu()).norm()) ** 2
                              for k in b) ** 0.5
        assert l2(got, want) <= 2e-2 * l2(want, init)
    else:
        assert err <= 1e-5 * top, err / top


@pytest.mark.cuda
def test_capture_raises_on_a_host_sync(cuda_device):
    """An iteration that reads a value back to the host cannot be
    captured: the capture raises, and the loop does not go on eagerly."""
    from exploring_meta_tpu_torch.utils import graphs
    state = torch.zeros((), device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def iteration():
        x = torch.rand((), generator=gen, device=cuda_device)
        state.add_(x * float(x > 2.0))       # float(): a host sync
        return {"s": state * 1.0}

    graphs.reset_counts()
    loop = graphs.FusedIterations(iteration, 3, cuda_device, (gen,))
    calls, step = [], loop.step

    def counted():
        calls.append(torch.cuda.is_current_stream_capturing())
        step()

    loop.step = counted
    with pytest.raises((RuntimeError,
                        getattr(torch, "AcceleratorError", RuntimeError))):
        loop(3)
    torch.cuda.synchronize()
    assert graphs.COUNTS == {"captures": 0, "replays": 0}
    assert loop.graph is None
    # the eager warm-up, then the capture that failed; nothing after it
    assert calls == [False, True]


@pytest.mark.cuda
def test_cl_matrix_card_vs_cpu_on_one_pool(cuda_device):
    """One vision CL matrix from one pool sampled once on the card: the
    adapted params and logits against the CPU's, accuracy entries equal
    but for counted tie flips (``chip_smoke.cl_card_vs_cpu``); MAML and
    ANIL."""
    from exploring_meta_tpu_torch.tasks.sampler import sample_task_batch
    from exploring_meta_tpu_torch.models.cnn4 import anil_omniglot_spec
    from exploring_meta_tpu_torch.tasks.datasets import get_dataset
    _, _, ds = get_dataset("omni", seed=0, synthetic=True, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    pool = sample_task_batch(gen, ds, 5, 1, 4)
    for spec, anil in ((omniglot_spec(5), False), (anil_omniglot_spec(5),
                                                    True)):
        res = chip_smoke.cl_card_vs_cpu(
            torch, init_cnn4(gen, spec, device="cuda"), spec, pool, anil=anil)
        assert res["adapted_err"] <= chip_smoke.ADAPT_TOL
        assert res["logit_err"] <= chip_smoke.CL_LOGIT_TOL


@pytest.mark.cuda
def test_eval_runs_launch_the_kernels(cuda_device, tmp_path):
    """eval_vision on a card-trained run dir launches the three CNN4
    kernels (and no double backward: it adapts first order), eval_rl (CL
    and RC) both sweeps; every artifact is written."""
    from exploring_meta_tpu_torch.analysis import eval_rl, eval_vision
    from exploring_meta_tpu_torch.trainers.rl import RLTrainer
    from exploring_meta_tpu_torch.trainers.vision import VisionTrainer
    from exploring_meta_tpu_torch.utils.config import (
        RLScriptConfig, VisionConfig,
    )
    vis = VisionTrainer(VisionConfig(num_iterations=2, meta_batch_size=4,
                                     save_every=1, synthetic=True),
                        path=str(tmp_path) + "/")
    vis.run()
    tc.reset_launch_counts()
    out = eval_vision.run(vis.model_path, n_eval_batches=1,
                          cl_params={"adapt_steps": 1, "inner_lr": 0.1,
                                     "n_tasks": 3},
                          rep_params={"adapt_steps": 1, "inner_lr": 0.1,
                                      "n_tasks": 2, "layers": [4]},
                          synthetic=True)
    counts = tc.launch_counts()
    assert counts.pop("cnn4_block_double_backward") == 0
    assert all(n > 0 for n in counts.values())
    assert len(out["cca_through_time"]) == 1
    rl = RLTrainer(RLScriptConfig(num_iterations=2, meta_batch_size=3,
                                  adapt_batch_size=5, max_path_length=20,
                                  n_eval_tasks=3, save_every=1),
                   path=str(tmp_path) + "/")
    rl.run()
    gc.reset_launch_counts()
    out = eval_rl.run(rl.model_path, run_cl=True, run_rc=True)
    assert all(n > 0 for n in gc.launch_counts().values())
    assert np.isfinite(out["eval"]["mean_reward"])
    for rel in ("cl_exp/cl_rew_matrix.out", "rep_exp/cca_rl_results.json",
                "rep_exp/rep_extra.json", "cca_through_time.json"):
        assert os.path.exists(os.path.join(rl.model_path, rel))


# -- one task a call: the cluster kernels ------------------------------------

# every N the port launches at B = 1: a one-image call, the vision
# baseline's Adam step, the served query forward and the served support set
_CLUSTER_NS = (1, 10, 15, 25)


def _cluster_inputs(rng, dev, n, h, ci, dtype):
    """_block_inputs at B = 1 in ``dtype``, the cotangent's kink mask taken
    again from the inputs as cast."""
    x, w, p, g = _block_inputs(rng, dev, 1, n, h, ci)
    x, w, p = x.to(dtype), w.to(dtype), [t.to(dtype) for t in p]
    xh, _, s, be = tc.bn_stats_plain(x, w, *p)
    return x, w, p, (g * ((xh * s + be).abs() > 1e-3)).to(dtype)


def _want_routes(calls):
    """routes() after ``calls``, [(kernel, x, w)], as the mirror plans them
    on this card's largest cluster."""
    cmax = tc.source_cluster_max()
    want = dict.fromkeys(tc.routes(), 0)
    for kernel, x, w in calls:
        b, n, h, wd, ci = x.shape
        plan = tc.cluster_plan(b, n, h, wd, ci, w.shape[-1], x.dtype, kernel,
                               cmax)
        want[tc.ROUTES[kernel][plan is None]] += 1
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", _CLUSTER_NS)
@pytest.mark.parametrize("h,ci", _BLOCKS)
def test_cluster_kernels_match_plain_twins(cuda_device, h, ci, n, dtype):
    """B = 1 runs each call on its planned route (fwd_cluster_kernel at
    blocks 2-4 where a CTA owns one tile, bwd_params_cluster_kernel at
    block 1 where it owns at most three, else the tiled kernels; by
    routes()): f32 within 1e-4 of the twins; bf16 every output but dy and
    db within one bf16 ulp of the float64 twin in all but
    cnn4_cuda.BF16_SHARE of its elements (chip_smoke.held_bf16), dy within
    float32's 1e-4, db by its magnitude; two calls bitwise equal."""
    x, w, p, g = _cluster_inputs(np.random.default_rng(7 * n + h), cuda_device,
                                 n, h, ci, dtype)
    tc.reset_launch_counts()
    got_f = tc.block_fwd(x, w, *p)
    got = tc.block_bwd_params(x, w, *p, g)
    assert tc.routes() == _want_routes([("cnn4_block_fwd", x, w),
                                        ("cnn4_block_bwd_params", x, w)])
    want = tc.block_bwd_params_plain(x, w, *p, g)
    _held(got[0], want[0], 1e-4)
    lim = _DB_TOL[dtype] * want[0].abs().sum(dim=(1, 2, 3))
    assert ((got[2].float() - want[2].float()).abs() <= lim).all()
    what = f"B 1 N {n} H {h}"
    if dtype == torch.float32:
        _held(got_f, tc.block_fwd_plain(x, w, *p), 1e-4)
        for i in (1, 3, 4):
            _held(got[i], want[i], 1e-4)
    else:
        f64 = torch.float64
        chip_smoke.held_bf16(tc, got_f, tc.block_fwd_plain(x, w, *p, acc=f64),
                             f"fwd {what}")
        want = tc.block_bwd_params_plain(x, w, *p, g, acc=f64)
        for i, name in ((1, "dw"), (3, "dscale"), (4, "dbias")):
            chip_smoke.held_bf16(tc, got[i], want[i], f"{name} {what}")
    assert torch.equal(got_f, tc.block_fwd(x, w, *p))
    again = tc.block_bwd_params(x, w, *p, g)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h,ci,route", [(14, 64, "fwd_cluster_kernel"),
                                        (28, 1, "bwd_params_cluster_kernel")])
def test_cluster_kernels_take_unaligned_inputs(cuda_device, h, ci, route,
                                               dtype):
    """x and w one element past a 16-byte boundary at N = 10, where the
    plan takes the cluster kernel: block 2's forward gathers its conv
    element by element in the tiled path's stages, block 1's bwd_params
    copies x and w element by element; held as above."""
    x, w, p, g = _cluster_inputs(np.random.default_rng(5), cuda_device, 10,
                                 h, ci, dtype)

    def unaligned(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        return out

    xu, wu = unaligned(x), unaligned(w)
    assert xu.data_ptr() % 16 and wu.data_ptr() % 16
    tc.reset_launch_counts()
    got_f = tc.block_fwd(xu, wu, *p)
    got = tc.block_bwd_params(xu, wu, *p, g)
    assert tc.routes()[route] == 1
    want = tc.block_bwd_params_plain(x, w, *p, g)
    _held(got[0], want[0], 1e-4)
    if dtype == torch.float32:
        _held(got_f, tc.block_fwd_plain(x, w, *p), 1e-4)
        for i in (1, 3, 4):
            _held(got[i], want[i], 1e-4)
    else:
        f64 = torch.float64
        chip_smoke.held_bf16(tc, got_f, tc.block_fwd_plain(x, w, *p, acc=f64),
                             "fwd unaligned")
        want = tc.block_bwd_params_plain(x, w, *p, g, acc=f64)
        for i in (1, 3, 4):
            chip_smoke.held_bf16(tc, got[i], want[i], f"output {i} unaligned")


@pytest.mark.cuda
def test_cluster_plan_is_the_sources(cuda_device):
    """cnn4_cuda.cluster_plan, on the card's largest cluster, mirrors the
    plan the source launches on (its exported cnn4_cluster_plan) at every
    block shape, task count and N around the route's edges, in both dtypes
    and for both kernels; an H100 schedules clusters of 16."""
    cmax = tc.source_cluster_max()
    assert cmax == 16
    for dtype in (torch.float32, torch.bfloat16):
        for kernel in tc.ROUTES:
            for h, ci in _BLOCKS + [(9, 8), (6, 3), (9, 1)]:
                for b in (1, 2, 8, 64):
                    for n in (0, 1, 5, 10, 15, 16, 20, 21, 25, 26, 128):
                        for co in (64, 32, 8, 12, 72):
                            args = (b, n, h, h, ci, co)
                            assert (tc.source_cluster_plan(dtype, kernel,
                                                           *args)
                                    == tc.cluster_plan(*args, dtype, kernel,
                                                       cmax)
                                    ), (dtype, kernel, args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cluster_launches_replay_their_eager_call(cuda_device, dtype):
    """The four blocks' forward and bwd_params at B = 1, N = 10 (the vision
    baseline's Adam step), captured in one CUDA graph: blocks 2-4's forward
    one launch of fwd_cluster_kernel each and block 1's bwd_params one of
    bwd_params_cluster_kernel (profiler; the rest the tiled kernels), the
    replay bit for bit the eager calls."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(3)
    ins = [_cluster_inputs(rng, cuda_device, 10, h, ci, dtype)
           for h, ci in _BLOCKS]

    def calls():
        return [(tc.block_fwd(x, w, *p),) + tc.block_bwd_params(x, w, *p, g)
                for x, w, p, g in ins]

    eager = calls()
    # CUPTI has been seen to drop a profiler session's first kernel record
    # on an H100: the session opens with a kernel of its own, and the CNN4
    # kernels are counted
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device=cuda_device).add_(1)
        calls()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and any(k in e.name for k in chip_smoke.CNN4_KERNEL_NAMES)]
    assert sum("fwd_cluster_kernel" in k for k in names) == 3, names
    assert sum("bwd_params_cluster_kernel" in k for k in names) == 1, names
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    tc.reset_launch_counts()
    with torch.cuda.graph(graph):
        captured = calls()
    assert tc.captured_routes() == {
        "fwd_cluster_kernel": 3, "fwd_tiled": 1,
        "bwd_params_cluster_kernel": 1, "bwd_params_tiled": 3,
        "double_bwd_kernels": 0, "double_bwd_plain": 0}
    graph.replay()
    torch.cuda.synchronize()
    for a, c in zip(eager, captured):
        assert all(torch.equal(u, v) for u, v in zip(a, c))


@pytest.mark.cuda
def test_batches_keep_the_tiled_kernels(cuda_device):
    """B = 64 (a served batch) and B = 8 take the tiled kernels; B = 1 at N
    = 10 block 2's forward and block 1's bwd_params the cluster kernels;
    each route counted once a call."""
    for b in (64, 8, 1):
        for h, ci, fwd, bwd in ((14, 64, "fwd_cluster_kernel",
                                 "bwd_params_tiled"),
                                (28, 1, "fwd_tiled",
                                 "bwd_params_cluster_kernel")):
            x, w, p, g = _block_inputs(np.random.default_rng(b), cuda_device,
                                       b, 10, h, ci)
            tc.reset_launch_counts()
            tc.block_fwd(x, w, *p)
            tc.block_bwd_params(x, w, *p, g)
            want = ({fwd, bwd} if b == 1
                    else {"fwd_tiled", "bwd_params_tiled"})
            assert tc.routes() == {k: int(k in want) for k in tc.routes()}, (
                b, h, tc.routes())


@pytest.mark.cuda
@pytest.mark.parametrize("h,ci", [(28, 1), (14, 64), (7, 64), (4, 64)])
def test_single_task_kernels_at_the_vision_baselines_n(cuda_device, h, ci):
    """B = 1, N = 10: the vision baseline's Adam step (one 5-way 1-shot
    task's images as one BN batch)."""
    x, w, p, g = _block_inputs(np.random.default_rng(ci + h), cuda_device,
                               1, 10, h, ci)
    torch.testing.assert_close(tc.block_fwd(x, w, *p),
                               tc.block_fwd_plain(x, w, *p),
                               rtol=1e-4, atol=1e-4)
    got = tc.block_bwd_params(x, w, *p, g)
    want = tc.block_bwd_params_plain(x, w, *p, g)
    for i in (0, 1, 3, 4):
        torch.testing.assert_close(got[i], want[i], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(tc.block_bwd_input(got[0], w, h, h),
                               tc.block_bwd_input_plain(got[0], w, h, h),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_baselines_launch_the_kernels(cuda_device, tmp_path):
    """The RL baselines launch each sweep once a task (the random policy
    the discount sweep alone), the vision baseline the CNN4 kernels 4 / 4
    / 3 an Adam step, each with its meta-test's launches."""
    from exploring_meta_tpu_torch.trainers import baselines
    from exploring_meta_tpu_torch.utils.config import (
        RLScriptConfig, VisionConfig,
    )
    cfg = RLScriptConfig(num_iterations=2, meta_batch_size=3,
                         adapt_batch_size=5, max_path_length=20,
                         n_eval_tasks=2)
    for cls, want in ((baselines.PPOBaseline, (8, 8)),
                      (baselines.TRPOBaseline, (9, 9)),
                      (baselines.RandomPolicyBaseline, (2, 8))):
        gc.reset_launch_counts()
        final = cls(cfg, path=str(tmp_path) + "/").run()
        assert tuple(gc.launch_counts().values()) == want, cls.__name__
        assert np.isfinite(final["mean_reward"])
    tc.reset_launch_counts()
    acc = baselines.VisionBaseline(
        VisionConfig(num_iterations=1, meta_batch_size=64, synthetic=True),
        path=str(tmp_path) + "/").run()
    # 5 Adam steps, then a meta-eval at B = 64
    assert tc.launch_counts() == {"cnn4_block_fwd": 28,
                                  "cnn4_block_bwd_params": 24,
                                  "cnn4_block_bwd_input": 18,
                                  "cnn4_block_double_backward": 0}
    assert 0.0 <= acc <= 1.0


@pytest.mark.cuda
def test_bf16_density_card_vs_cpu(cuda_device):
    """The bf16 policy on the card equals the CPU path but at bf16 ties
    (chip_smoke.bf16_tie_rows), and lies ~2^-8 from f32."""
    from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
    pol = DiagNormalPolicy(2, 2, compute_dtype="bf16")
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = pol.init(gen)
    states = torch.rand(2000, 2, generator=gen, device="cuda") - 0.5
    card = pol.density(params, states)[0].cpu()
    cpu = pol.density({k: (v.cpu() if k == "sigma" else
                           [{n: t.cpu() for n, t in layer.items()}
                            for layer in v]) for k, v in params.items()},
                      states.cpu())[0]
    err = (card - cpu).abs().max(dim=-1).values / cpu.abs().max()
    differ = err > 1e-6
    tie = chip_smoke.bf16_tie_rows(torch, params["mean"],
                                   ["relu", "relu", None], states)
    assert bool(tie[differ].all()) and float(differ.float().mean()) <= 0.01
    f32 = DiagNormalPolicy(2, 2).density(params, states)[0].cpu()
    assert 1e-4 < float((f32 - card).abs().max() / f32.abs().max()) < 3e-2


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ppo", "trpo", "vision"])
def test_fused_resume_equals_the_uninterrupted_run(cuda_device, tmp_path,
                                                   kind):
    """``--fuse 2``, 4 iterations against 2 + a resume from the chunk end
    ``model_1``: the resumed run's warm-up, capture and replays give the
    uninterrupted run's rows, final params and meta-test exactly."""
    from exploring_meta_tpu_torch.trainers.rl import RLTrainer
    from exploring_meta_tpu_torch.trainers.vision import VisionTrainer
    from exploring_meta_tpu_torch.utils import graphs
    from exploring_meta_tpu_torch.utils.config import (
        RLScriptConfig, VisionConfig,
    )

    def run(path, **kw):
        if kind == "vision":
            t = VisionTrainer(VisionConfig(num_iterations=4,
                                           meta_batch_size=2, shots=1,
                                           synthetic=True, fuse=2,
                                           save_every=1, **kw),
                              path=str(path) + "/")
        else:
            t = RLTrainer(RLScriptConfig(num_iterations=4, meta_batch_size=3,
                                         adapt_batch_size=4,
                                         max_path_length=12, n_eval_tasks=2,
                                         outer_lr=0.01, fuse=2, save_every=1,
                                         **kw), algo=kind,
                          path=str(path) + "/")
        graphs.reset_counts()
        out = t.run()
        return t, out, dict(graphs.COUNTS)

    full, full_out, _ = run(tmp_path / "full")
    ckpt = os.path.join(full.model_path, "model_checkpoints", "model_1.npz")
    res, res_out, counts = run(tmp_path / "res", resume=ckpt)
    # iteration 2 the eager warm-up, iteration 3 captured and replayed
    assert counts == {"captures": 1, "replays": 1}
    assert res_out == full_out
    for k, rows in res.metrics.items():
        assert rows == full.metrics[k][len(full.metrics[k]) - len(rows):], k
    a = _npz(os.path.join(full.model_path, "model.npz"))
    b = _npz(os.path.join(res.model_path, "model.npz"))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.cuda
def test_async_checkpoints_equal_sync_under_replays(cuda_device, tmp_path):
    """maml_ppo ``--fuse 2`` with a checkpoint at every chunk end, written
    on the writer thread while the next chunk's replays step the params in
    place: every file equals the synchronous run's."""
    from exploring_meta_tpu_torch.trainers.rl import RLTrainer
    from exploring_meta_tpu_torch.utils.config import RLScriptConfig
    runs = {}
    for mode in (False, True):
        t = RLTrainer(RLScriptConfig(num_iterations=6, meta_batch_size=3,
                                     adapt_batch_size=4, max_path_length=12,
                                     n_eval_tasks=2, outer_lr=0.01, fuse=2,
                                     save_every=1, async_ckpt=mode),
                      algo="ppo", path=str(tmp_path / str(mode)) + "/")
        t.run()
        ck = os.path.join(t.model_path, "model_checkpoints")
        runs[mode] = {f: _npz(os.path.join(ck, f)) for f in os.listdir(ck)}
    assert sorted(runs[True]) == ["model_1.npz", "model_3.npz",
                                  "model_5.npz"]
    for f, flat in runs[False].items():
        assert "__torch_rng__/cuda" in flat and "__rng__" not in flat
        for k, v in flat.items():
            np.testing.assert_array_equal(runs[True][f][k], v,
                                          err_msg=f"{f} {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["trpo", "ppo"])
def test_seeded_scan_one_capture_and_one_seeds_launches(cuda_device, algo):
    """A tiny one-program sweep of 3 seeds (``make_seeded_*_train_scan``,
    3 iterations: the eager warm-up, one capture, two replays) records
    each sweep kernel as often a seeded iteration as one seed's solo scan
    does. Seed 1's first row (the rollouts of its initial params) is its
    solo scan's within 1e-5; PPO's whole run within 1e-4 of max|params|.
    TRPO's later iterations are not held: batched GEMMs at S·B tasks round
    otherwise than at B, and f32 CG and the next rollouts amplify that
    (chip_smoke.py phase 13 holds one iteration and reports the rest)."""
    from exploring_meta_tpu_torch.adapt.maml import adam
    from exploring_meta_tpu_torch.envs.particles2d import Particles2D
    from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
    from exploring_meta_tpu_torch.parallel.multiseed import (
        seed_params, stack_seed_states,
    )
    from exploring_meta_tpu_torch.rl import train_scan as ts
    from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig
    from exploring_meta_tpu_torch.rl.rollout import make_rollout
    from exploring_meta_tpu_torch.rl.trpo_meta import TRPOConfig
    from exploring_meta_tpu_torch.utils import graphs
    from exploring_meta_tpu_torch.utils.tree import tree_leaves, tree_map
    S, mb, n = 3, 4, 3
    env, pol = Particles2D(), DiagNormalPolicy(2, 2)
    cfg = RLConfig(inner_lr=0.05, adapt_batch_size=5, max_path_length=20)
    roll = make_rollout(env, pol.sample, 5, 20)
    lr = None if algo == "trpo" else 0.01

    def run(seeds):
        gc.reset_launch_counts()
        graphs.reset_counts()
        if seeds is None:
            gen = torch.Generator(device=cuda_device).manual_seed(1)
            params = pol.init(gen)
            opt = None
            if lr is not None:
                params = tree_map(torch.Tensor.requires_grad_, params)
                opt = adam(params, lr)
        else:
            params, opt, gen = stack_seed_states(pol.init, range(S),
                                                 cuda_device, outer_lr=lr)
        if algo == "trpo":
            args = (env, pol, roll, cfg, TRPOConfig(), mb, n)
            train = (ts.make_trpo_train_scan(*args) if seeds is None
                     else ts.make_seeded_trpo_train_scan(*args, seeds))
            ms = train(params, gen)[-1]
        else:
            args = (env, pol, roll, cfg, algo, mb, n)
            train = (ts.make_adam_train_scan(*args) if seeds is None
                     else ts.make_seeded_adam_train_scan(*args, seeds))
            ms = train(params, opt, gen)[-1]
        torch.cuda.synchronize()
        return (params, ms, dict(graphs.COUNTS), gc.launch_counts(),
                gc.captured_counts())

    params, ms, counts, launches, captured = run(S)
    solo_params, solo_ms, solo_counts, solo_launches, solo_captured = run(
        None)
    assert counts == solo_counts == {"captures": 1, "replays": n - 1}
    assert launches == solo_launches and captured == solo_captured
    assert all(v > 0 for v in captured.values())
    assert all(v.shape == (n, S) for v in ms.values())
    # seed 1 against its solo scan
    for k in ("adapt_reward", "adapt_success"):
        torch.testing.assert_close(ms[k][0, 1], solo_ms[k][0], rtol=1e-5,
                                   atol=1e-5)
    got = [t.detach() for t in tree_leaves(seed_params(params, 1))]
    want = [t.detach() for t in tree_leaves(solo_params)]
    assert all(bool(torch.isfinite(g).all()) for g in got)
    if algo == "ppo":
        top = max(float(w.abs().max()) for w in want)
        assert max(float((g - w).abs().max())
                   for g, w in zip(got, want)) <= 1e-4 * top


# -- serving as CUDA graphs, one a request bucket ---------------------------

def _vision_requests(dev, b, hw=28, ch=1):
    gen = torch.Generator(device=dev).manual_seed(b)
    sx = torch.randn((b, 25, hw, hw, ch), generator=gen, device=dev)
    sy = torch.arange(5, device=dev).repeat(b, 5)
    qx = torch.randn((b, 15, hw, hw, ch), generator=gen, device=dev)
    return sx, sy, qx


def _equal(a, b) -> bool:
    from exploring_meta_tpu_torch.utils.tree import tree_leaves
    return all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_vision_buckets_replay_their_eager_call(cuda_device, dtype):
    """5 requests: bucket 8's first call runs the kernels eagerly and
    records them; 7 and 5 again are replays of that graph, launching no
    wrapper, the second 5 bit for bit the first."""
    from exploring_meta_tpu_torch.utils import graphs
    spec = omniglot_spec(ways=5)
    params = init_cnn4(torch.Generator().manual_seed(0), spec,
                       device=cuda_device)
    server = VisionServer(spec, params, inner_lr=0.5, adapt_steps=1,
                          compute_dtype=dtype)
    sx, sy, qx = _vision_requests(cuda_device, 7)
    graphs.reset_counts()
    tc.reset_launch_counts()
    first = server.batch(sx[:5], sy[:5], qx[:5])
    torch.cuda.synchronize()
    eager = {"cnn4_block_fwd": 8, "cnn4_block_bwd_params": 4,
             "cnn4_block_bwd_input": 3,
             "cnn4_block_double_backward": 0}
    assert tc.launch_counts() == tc.captured_counts() == eager
    seven = server.batch(sx, sy, qx)
    again = server.batch(sx[:5], sy[:5], qx[:5])
    torch.cuda.synchronize()
    assert graphs.COUNTS == {"captures": 1, "replays": 2}
    assert tc.launch_counts() == eager
    assert _equal(first, again)
    assert seven[1].shape == (7, 15, 5) and first[1].dtype == torch.float32
    one = server(sx[0], sy[0], qx[0])
    assert _equal(server(sx[0], sy[0], qx[0]), one)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["vpg", "ppo", "trpo"])
def test_policy_buckets_replay_their_eager_call(cuda_device, algo):
    """Adaptation, act and the sampled fleet as graphs: each replay bit for
    bit its eager first call, the sampled one from the same generator
    state."""
    from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig
    from exploring_meta_tpu_torch.serve import PolicyServer
    from exploring_meta_tpu_torch.utils import graphs
    from exploring_meta_tpu_torch.utils.tree import tree_map
    policy, params, stack = _policy_supports(5, cuda_device)
    server = PolicyServer(policy, params,
                          RLConfig(**chip_smoke.SERVE_RL_CFG), algo=algo)
    graphs.reset_counts()
    gc.reset_launch_counts()
    first = server.adapt_batched(stack)
    torch.cuda.synchronize()
    assert gc.launch_counts() == gc.captured_counts() == {
        "gae_sweep": 1, "discount_sweep": 1}
    assert _equal(server.adapt_batched(stack), first)
    assert graphs.COUNTS == {"captures": 1, "replays": 1}
    assert gc.launch_counts() == {"gae_sweep": 1, "discount_sweep": 1}
    obs = stack.state[:, 0]
    one = tree_map(lambda t: t[0], first)
    assert _equal(server.act(one, obs[0]), server.act(one, obs[0]))
    assert _equal(server.act_batched(first, obs),
                  server.act_batched(first, obs))
    gen = torch.Generator(device=cuda_device)
    draws = []
    graphs.reset_counts()
    for g in (gen, gen, torch.Generator(device=cuda_device)):
        g.manual_seed(4)
        draws.append((server.sample_batched(first, g, obs), g.get_state()))
    # a new generator replays the one capture from its own state
    assert graphs.COUNTS == {"captures": 1, "replays": 2}
    for drawn, state in draws[1:]:
        assert _equal(drawn, draws[0][0])
        assert torch.equal(state, draws[0][1])


@pytest.mark.cuda
def test_categorical_fleet_samples_as_a_graph(cuda_device):
    """A categorical policy's draw captures (no host sync): its replays
    draw what the eager call drew, and what torch.multinomial draws from
    the same generator state."""
    from exploring_meta_tpu_torch.models.policies import CategoricalPolicy
    from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig
    from exploring_meta_tpu_torch.serve import PolicyServer
    from exploring_meta_tpu_torch.utils import graphs
    from exploring_meta_tpu_torch.utils.tree import tree_map
    cat = CategoricalPolicy(10, 4, hiddens=(16,))
    params = cat.init(torch.Generator().manual_seed(0), device="cpu")
    server = PolicyServer(cat, params, RLConfig())
    g = torch.Generator(device=cuda_device).manual_seed(1)
    fleet = tree_map(lambda t: t.to(cuda_device) + 0.3 * torch.randn(
        (5,) + tuple(t.shape), generator=g, device=cuda_device), params)
    states = torch.randint(0, 10, (5, 7), generator=g, device=cuda_device)
    graphs.reset_counts()
    draws = []
    for _ in range(2):
        g.manual_seed(2)
        draws.append(server.sample_batched(fleet, g, states))
    assert graphs.COUNTS == {"captures": 1, "replays": 1}
    assert _equal(draws[0], draws[1])
    # the draw is made over the bucket of 8 (the first task repeated)
    padded = tree_map(lambda t: torch.cat([t, t[:1].expand(
        (3,) + tuple(t.shape[1:]))]), (fleet, states))
    probs = torch.softmax(cat.logits(*padded).float(), -1)
    g.manual_seed(2)
    want = torch.multinomial(probs.reshape(-1, 4), 1, generator=g)
    assert torch.equal(draws[1][0], want.reshape(8, 7)[:5])


@pytest.mark.cuda
def test_threads_share_a_server(cuda_device):
    """Four threads serving act_batched at once each get their own
    observations' actions."""
    from concurrent.futures import ThreadPoolExecutor
    from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig
    from exploring_meta_tpu_torch.serve import PolicyServer
    from exploring_meta_tpu_torch.utils.tree import tree_map
    policy, params, stack = _policy_supports(5, cuda_device)
    server = PolicyServer(policy, params, RLConfig())
    fleet = tree_map(lambda t: t.to(cuda_device).expand(
        (5,) + tuple(t.shape)), params)
    sets = [stack.state[:, 0] + 0.01 * k for k in range(4)]
    alone = [server.act_batched(fleet, o) for o in sets]

    def serve(k):
        return all(torch.equal(server.act_batched(fleet, sets[k]), alone[k])
                   for _ in range(20))

    with ThreadPoolExecutor(4) as pool:
        assert all(pool.map(serve, range(4)))


@pytest.mark.cuda
def test_mini_imagenet_server_captures_on_cudnn(cuda_device):
    """The max-pool CNN4 runs per op on cuDNN; its eager warm-up picks the
    algorithms before the capture. cuDNN's backward algorithms are not
    bitwise repeatable run to run, so the replay is held at 1e-4 of the
    eager call's probabilities, as a request against its batch."""
    from exploring_meta_tpu_torch.models.cnn4 import mini_imagenet_spec
    from exploring_meta_tpu_torch.utils import graphs
    spec = mini_imagenet_spec(5)
    params = init_cnn4(torch.Generator().manual_seed(0), spec,
                       device=cuda_device)
    server = VisionServer(spec, params, inner_lr=0.5, adapt_steps=1)
    sx, sy, qx = _vision_requests(cuda_device, 3, hw=84, ch=3)
    graphs.reset_counts()
    first = server.batch(sx, sy, qx)
    again = server.batch(sx, sy, qx)
    with graphs.run_eagerly():
        eager = server.batch(sx, sy, qx)
    assert graphs.COUNTS == {"captures": 1, "replays": 1}
    for got in (again, eager):
        assert float((got[1] - first[1]).abs().max()) <= 1e-4
