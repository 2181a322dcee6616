"""One-program seed sweeps of the PyTorch port
(``exploring_meta_tpu_torch/parallel/multiseed.py`` and the seeded
builders) on the CPU, row for row against solo runs
(``tests/test_torch_multiseed_jax.py`` holds them against JAX's ``vmap``
over seeds).

- ``stack_seed_states`` derives each seed's params and generator as a
  solo trainer run does, bit for bit; one Adam over the stacked leaves
  steps as S Adams, bit for bit; the bridge carries JAX's stacked params
  both ways.
- CG on ``[S, P]`` rows equals each row's solo CG bit for bit, and a seed
  whose line search accepts nothing keeps its params while the other
  seed's step is its solo one.
- Row i of the seeded TRPO, PPO, VPG and MAML vision scans equals the
  solo scan of seed i bit for bit (one intra-op thread: the same
  arithmetic at S·B tasks as at B); ANIL vision, whose solo body is shared
  by the tasks, is held at 1e-4 of max|params| but for its conv biases
  (BN removes them: their gradient is rounding, which Adam's first step
  turns into +-lr).
"""

import jax
import numpy as np
import pytest
import torch

from exploring_meta_tpu import parallel as jparallel
from exploring_meta_tpu.models import cnn4 as jcnn
from exploring_meta_tpu_torch.adapt import maml as tm
from exploring_meta_tpu_torch.adapt.vision import make_vision_fast_adapt
from exploring_meta_tpu_torch.envs.particles2d import Particles2D
from exploring_meta_tpu_torch.models import cnn4 as tcnn
from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
from exploring_meta_tpu_torch.ops.cg import (
    conjugate_gradient, grad_vector_product,
)
from exploring_meta_tpu_torch.parallel import multiseed as ms
from exploring_meta_tpu_torch.rl import adapt_rl as trl
from exploring_meta_tpu_torch.rl import train_scan as tts
from exploring_meta_tpu_torch.rl import trpo_meta as ttm
from exploring_meta_tpu_torch.rl.rollout import make_rollout
from exploring_meta_tpu_torch.tasks.datasets import get_dataset
from exploring_meta_tpu_torch.tasks.sampler import sample_task_batch
from exploring_meta_tpu_torch.utils.bridge import (
    params_from_jax, params_to_numpy,
)
from exploring_meta_tpu_torch.utils.tree import (
    tree_items, tree_leaves, tree_map,
)

SEEDS = [42, 7]
S = len(SEEDS)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the seeded and solo runs then reduce in the same
    order, and small runs do not contend with other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# stacked state
# --------------------------------------------------------------------------

def _vision_init(spec):
    return lambda g: tcnn.init_cnn4(g, spec, device="cpu")


@pytest.mark.parametrize("kind", ["policy", "cnn4"])
def test_stack_seed_states_is_the_trainers_derivation(kind):
    init = (DiagNormalPolicy(2, 2).init if kind == "policy"
            else _vision_init(tcnn.omniglot_spec(5, hidden=8)))
    params, opt, gens = ms.stack_seed_states(init, SEEDS, "cpu")
    assert opt is None and len(gens) == S
    for i, s in enumerate(SEEDS):
        gen = torch.Generator().manual_seed(s)
        solo = init(gen)
        for (k, a), (_, b) in zip(tree_items(ms.seed_params(params, i)),
                                  tree_items(solo)):
            assert torch.equal(a, b), k
        assert torch.equal(gens[i].get_state(), gen.get_state())
        # and the streams go on alike
        assert torch.equal(torch.rand(3, generator=gens[i]),
                           torch.rand(3, generator=gen))


def test_one_adam_over_stacked_leaves_is_s_adams():
    params, opt, _ = ms.stack_seed_states(DiagNormalPolicy(2, 2).init, SEEDS,
                                          "cpu", outer_lr=0.01)
    assert all(t.requires_grad for t in tree_leaves(params))
    solo = [tree_map(lambda t: t.clone().requires_grad_(),
                     ms.seed_params(params, i)) for i in range(S)]
    opts = [tm.adam(p, 0.01) for p in solo]
    rng = np.random.default_rng(0)
    for k in (-3, 0, 2):            # gradients of very different scales
        grads = [torch.tensor(rng.normal(size=t.shape) * 10.0 ** k,
                              dtype=torch.float32)
                 for t in tree_leaves(params)]
        for p, g in zip(tree_leaves(params), grads):
            p.grad = g.clone()
        opt.step()
        for i in range(S):
            for p, g in zip(tree_leaves(solo[i]), grads):
                p.grad = g[i].clone()
            opts[i].step()
    for i in range(S):
        for a, b in zip(tree_leaves(ms.seed_params(params, i)),
                        tree_leaves(solo[i])):
            assert torch.equal(a, b.detach())


def test_seeded_copies_are_seed_major_and_route_gradients_per_seed():
    x = {"w": torch.arange(6.0).reshape(S, 3).requires_grad_()}
    copies = ms.seeded(x, 2)
    assert copies["w"].shape == (4, 3)
    assert torch.equal(copies["w"][:2], x["w"][:1].expand(2, 3))
    assert torch.equal(copies["w"][2:], x["w"][1:].expand(2, 3))
    weights = torch.tensor([1.0, 2.0, 3.0, 4.0]).unsqueeze(-1)
    (g,) = torch.autograd.grad((copies["w"] * weights).sum(), x["w"])
    assert torch.equal(g, torch.tensor([[3.0] * 3, [7.0] * 3]))
    assert torch.equal(ms.seed_means(torch.arange(4.0), 2),
                       torch.tensor([0.5, 2.5]))
    assert float(ms.seed_means(torch.arange(4.0), None)) == 1.5
    gens = tuple(torch.Generator().manual_seed(s) for s in SEEDS)
    drawn = ms.seed_draws(lambda g: (torch.rand(2, generator=g),
                                     torch.zeros(2)), gens, S)
    assert drawn[0].shape == drawn[1].shape == (4,)
    assert torch.equal(drawn[0][2:], torch.rand(
        2, generator=torch.Generator().manual_seed(7)))


def test_mesh_is_refused_as_scale_out():
    """The seed axis over a ``--mesh`` (since the scale-out slice):
    contiguous equal groups, one a rank; a count the mesh does not divide
    raises JAX's ``vmap_seeds`` message."""
    assert ms.seed_groups([42, 7, 1, 2], 2) == [[42, 7], [1, 2]]
    assert ms.seed_groups([42, 7], 1) == [[42, 7]]
    with pytest.raises(ValueError, match="cannot shard evenly over the "
                       "2-device mesh"):
        ms.seed_groups([42, 7, 1], 2)


def test_bridge_carries_a_stacked_tree_both_ways():
    spec = jcnn.omniglot_spec(ways=5, hidden=8, layers=2)
    jparams, _, _ = jparallel.stack_seed_states(
        lambda ik: jcnn.init_cnn4(ik, spec), SEEDS)
    template = tcnn.init_cnn4(torch.Generator(), tcnn.omniglot_spec(
        5, hidden=8, layers=2), device="cpu")
    params = params_from_jax(jparams, "cpu", template=template, seeds=S)
    with pytest.raises(ValueError, match="template"):
        params_from_jax(jparams, "cpu", template=template)
    back = params_to_numpy(params)
    for (k, a), (_, b) in zip(tree_items(back), tree_items(
            jax.tree_util.tree_map(np.asarray, jparams))):
        np.testing.assert_array_equal(a, b, err_msg=k)
    for i in range(S):
        want = jax.tree_util.tree_map(lambda x: np.asarray(x[i]), jparams)
        for (k, a), (_, b) in zip(
                tree_items(params_to_numpy(ms.seed_params(params, i))),
                tree_items(want)):
            np.testing.assert_array_equal(a, b, err_msg=k)


# --------------------------------------------------------------------------
# the natural-gradient step on [S, P] rows
# --------------------------------------------------------------------------

def test_seeded_cg_rows_are_solo_solves():
    rng = np.random.default_rng(3)
    P = 6
    mats = []
    for _ in range(S):
        m = rng.normal(size=(P, P))
        mats.append(torch.tensor(m @ m.T + P * np.eye(P), dtype=torch.float32))
    b = torch.tensor(rng.normal(size=(S, P)), dtype=torch.float32)

    def grad_of(x, rows):
        with torch.enable_grad():
            f = sum(0.5 * x[i] @ mats[r] @ x[i] for i, r in enumerate(rows))
            return torch.autograd.grad(f, x, create_graph=True)[0]

    x = torch.zeros(S, P, requires_grad=True)
    rows = conjugate_gradient(grad_vector_product(grad_of(x, range(S)), x,
                                                  1e-5), b)
    for i in range(S):
        assert torch.equal(rows[i], conjugate_gradient(_solo_fvp(mats[i]),
                                                       b[i]))
    torch.testing.assert_close(rows[0], torch.linalg.solve(
        mats[0] + 1e-5 * torch.eye(P), b[0]), rtol=1e-4, atol=1e-5)


def _solo_fvp(mat):
    """A solo run's Fisher-vector product of ``0.5 x A x``, damped 1e-5."""
    x = torch.zeros(mat.shape[0], requires_grad=True)
    with torch.enable_grad():
        g = torch.autograd.grad(0.5 * x @ mat @ x, x, create_graph=True)[0]
    return grad_vector_product(g, x, 1e-5)


def test_a_rejected_seed_keeps_its_params_the_other_takes_its_solo_step():
    """Seed 1's KL carries a constant offset above max_kl (its gradient and
    Fisher are unchanged), so its line search accepts nothing; seed 0's
    row is its solo step."""
    rng = np.random.default_rng(4)
    P = 5
    g = torch.tensor(rng.normal(size=(S, P)), dtype=torch.float32)
    f = torch.tensor(rng.uniform(0.5, 2.0, size=(S, P)), dtype=torch.float32)
    x0 = torch.tensor(rng.normal(size=(S, P)), dtype=torch.float32)
    offset = torch.tensor([0.0, 1.0])
    cfg = ttm.TRPOConfig(outer_lr=1.0, max_kl=0.01, ls_max_steps=6)

    def terms(x, i):
        d = x - x0[i]
        return (g[i] * d).sum(-1), 0.5 * (f[i] * d * d).sum(-1) + offset[i]

    def rows_loss_kl(x):
        parts = [terms(x[i], i) for i in range(S)]
        return (torch.stack([p[0] for p in parts]),
                torch.stack([p[1] for p in parts]))

    final, info = ttm.natural_gradient_step(rows_loss_kl, x0, cfg,
                                            host_free=True)
    assert info["accepted"].tolist() == [True, False]
    assert torch.equal(final[1], x0[1])
    solo, sinfo = ttm.natural_gradient_step(lambda x: terms(x, 0), x0[0], cfg,
                                            host_free=True)
    assert bool(sinfo["accepted"])
    assert torch.equal(final[0], solo) and not torch.equal(solo, x0[0])
    with pytest.raises(ValueError, match="host-free"):
        ttm.natural_gradient_step(rows_loss_kl, x0, cfg)


# --------------------------------------------------------------------------
# rows of the seeded scans against solo scans
# --------------------------------------------------------------------------

WAYS, LR, OUTER_LR = 5, 0.4, 0.003
RL_SMALL = dict(inner_lr=0.05, adapt_batch_size=3, max_path_length=8)
N_STEPS, MB = 3, 2


def _rl_scans(algo):
    env, pol = Particles2D(), DiagNormalPolicy(2, 2, hiddens=(16, 16))
    cfg = trl.RLConfig(**RL_SMALL)
    roll = make_rollout(env, pol.sample, 3, 8)
    if algo == "trpo":
        args = (env, pol, roll, cfg, ttm.TRPOConfig(), MB, N_STEPS)
        return (pol, tts.make_seeded_trpo_train_scan(*args, S),
                lambda: tts.make_trpo_train_scan(*args), None)
    args = (env, pol, roll, cfg, algo, MB, N_STEPS)
    return (pol, tts.make_seeded_adam_train_scan(*args, S),
            lambda: tts.make_adam_train_scan(*args), 0.01)


@pytest.mark.parametrize("algo", ["trpo", "ppo", "vpg"])
def test_seeded_rl_scan_rows_equal_solo_runs(algo):
    pol, seeded_train, solo_train, lr = _rl_scans(algo)
    params, opt, gens = ms.stack_seed_states(pol.init, SEEDS, "cpu",
                                             outer_lr=lr)
    state = (params,) if opt is None else (params, opt)
    *_, metrics = seeded_train(*state, gens)
    assert seeded_train.fused.bound().buffer.shape[1:] == (
        len(metrics), S)
    for i, s in enumerate(SEEDS):
        gen = torch.Generator().manual_seed(s)
        p = pol.init(gen)
        if lr is None:
            _, m1 = solo_train()(p, gen)
        else:
            p = tree_map(torch.Tensor.requires_grad_, p)
            _, _, m1 = solo_train()(p, tm.adam(p, lr), gen)
        assert list(metrics) == list(m1)
        for k in m1:
            assert metrics[k].shape == (N_STEPS, S)
            assert torch.equal(metrics[k][:, i], m1[k]), k
        for a, b in zip(tree_leaves(ms.seed_params(params, i)),
                        tree_leaves(p)):
            assert torch.equal(a, b.detach())
        # the generators stand where the solo runs' stand
        assert torch.equal(gens[i].get_state(), gen.get_state())


@pytest.fixture(scope="module")
def omni_small():
    train_ds, valid_ds, _ = get_dataset("omni", seed=0, synthetic=True,
                                        device="cpu")
    return train_ds, valid_ds


@pytest.mark.parametrize("anil", [False, True], ids=["maml", "anil"])
def test_seeded_vision_scan_rows_equal_solo_runs(omni_small, anil):
    train_ds, valid_ds = omni_small
    spec = (tcnn.anil_omniglot_spec(WAYS) if anil
            else tcnn.omniglot_spec(WAYS, hidden=8))
    sampler = lambda ds: (lambda g: sample_task_batch(g, ds, WAYS, 1, MB))

    def scan(seeds):
        return tm.make_train_scan(
            make_vision_fast_adapt(spec, LR, 1, 1, WAYS, anil=anil,
                                   seeds=seeds),
            sampler(train_ds), 2, eval_sample_fn=sampler(valid_ds),
            seeds=seeds)

    params, opt, gens = ms.stack_seed_states(_vision_init(spec), SEEDS,
                                             "cpu", outer_lr=OUTER_LR)
    _, _, metrics = scan(S)(params, opt, gens)
    for i, s in enumerate(SEEDS):
        gen = torch.Generator().manual_seed(s)
        p = tree_map(torch.Tensor.requires_grad_, _vision_init(spec)(gen))
        _, _, m1 = scan(None)(p, tm.adam(p, OUTER_LR), gen)
        got = dict(tree_items(params_to_numpy(ms.seed_params(params, i))))
        if not anil:
            for k in m1:
                assert torch.equal(metrics[k][:, i], m1[k]), k
            for k, b in tree_items(params_to_numpy(p)):
                np.testing.assert_array_equal(got[k], b, err_msg=k)
            continue
        for k in m1:
            torch.testing.assert_close(metrics[k][:, i], m1[k], rtol=1e-5,
                                       atol=1e-5)
        top = max(np.abs(b).max() for b in tree_leaves(params_to_numpy(p)))
        for k, b in tree_items(params_to_numpy(p)):
            if k.endswith("conv/b"):      # BN removes them: noise
                continue
            np.testing.assert_allclose(got[k], b, rtol=0, atol=1e-4 * top,
                                       err_msg=k)
