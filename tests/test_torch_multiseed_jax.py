"""One-program seed sweeps of the PyTorch port against the JAX package's
``vmap`` over seeds, on the CPU.

- The seeded vision meta-step (``omniglot_spec(5, hidden=8, layers=2)``,
  S = 2 seeds x 2 tasks; JAX's ``stack_seed_states`` params through the
  bridge; task batches sampled by JAX) against ``jax.vmap(make_meta_step)``
  under ``optax.adam(0.1)``: losses to 1e-5 relative, the stepped params
  within 1e-5 of lr (Adam's first step is lr x sign(g): this holds the
  signs). The conv biases are noise (BN removes them; their gradient is
  rounding), so they are held to a step of at most lr.
- The seeded TRPO outer step on JAX-collected replays of S = 2 seeds
  against ``jax.vmap(make_trpo_meta_step)`` in float64: the port's
  float64 step within 1e-5 of each seed's step (1.1e-6 measured: JAX
  keeps ``done``, ``valid`` and ``success`` in float32), its float32 step
  within 2e-2 (f32 CG on a Fisher damped by 1e-5;
  ``test_torch_rl_trpo.py``), and bit for bit against the port's solo
  step of each seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from exploring_meta_tpu import adapt as jadapt
from exploring_meta_tpu import parallel as jparallel
from exploring_meta_tpu import tasks as jtasks
from exploring_meta_tpu.envs.particles2d import Particles2D as JEnv
from exploring_meta_tpu.models import cnn4 as jcnn
from exploring_meta_tpu.models.policies import DiagNormalPolicy as JPolicy
from exploring_meta_tpu.rl import adapt_rl as jrl
from exploring_meta_tpu.rl import trpo_meta as jtm
from exploring_meta_tpu.rl.rollout import rollout as jrollout
from exploring_meta_tpu_torch.adapt import maml as tm
from exploring_meta_tpu_torch.adapt.vision import make_vision_fast_adapt
from exploring_meta_tpu_torch.models import cnn4 as tcnn
from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
from exploring_meta_tpu_torch.parallel import multiseed as ms
from exploring_meta_tpu_torch.rl import adapt_rl as trl
from exploring_meta_tpu_torch.rl import trpo_meta as ttm
from exploring_meta_tpu_torch.rl.rollout import Trajectory
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
    """One intra-op thread: the seeded and solo steps then reduce in the
    same order, and small runs do not contend with other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# vision: the seeded meta-step against jax.vmap(make_meta_step)
# --------------------------------------------------------------------------

WAYS, B_TASKS, LR = 5, 2, 0.4
# the step against optax: 1e-5 of lr must stay above float32's resolution
# of O(1) params (6e-8)
JAX_OUTER_LR = 0.1


def test_seeded_vision_meta_step_matches_vmapped_jax():
    jspec = jcnn.omniglot_spec(ways=WAYS, hidden=8, layers=2)
    tspec = tcnn.omniglot_spec(WAYS, hidden=8, layers=2)
    opt = optax.adam(JAX_OUTER_LR)
    jparams, jopt, keys = jparallel.stack_seed_states(
        lambda ik: jcnn.init_cnn4(ik, jspec), SEEDS, opt)
    train, _, _ = jtasks.load_omniglot(seed=0, synthetic=True,
                                       synthetic_classes=20)
    data, labels = jax.vmap(lambda k: jtasks.sample_task_batch(
        k, train, WAYS, 1, B_TASKS))(keys)
    fa = jadapt.make_vision_fast_adapt(jspec, LR, 1, 1, WAYS)
    jnew, _, jm = jax.vmap(jadapt.make_meta_step(fa, opt))(
        jparams, jopt, data, labels)

    template = tcnn.init_cnn4(torch.Generator(), tspec, device="cpu")
    params = tree_map(torch.Tensor.requires_grad_, params_from_jax(
        jparams, "cpu", template=template, seeds=S))
    step = tm.make_meta_step(make_vision_fast_adapt(tspec, LR, 1, 1, WAYS,
                                                    seeds=S), seeds=S)
    flat = lambda a: torch.from_numpy(np.array(a)).flatten(0, 1)
    _, _, m = step(params, tm.adam(params, JAX_OUTER_LR), flat(data),
                   flat(labels).long())
    assert m["loss"].shape == m["metric"].shape == (S,)
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(m["metric"].numpy(), np.asarray(jm["metric"]),
                               atol=1e-6)
    want = dict(tree_items(jax.tree_util.tree_map(np.asarray, jnew)))
    before = dict(tree_items(jax.tree_util.tree_map(np.asarray, jparams)))
    for k, got in tree_items(params_to_numpy(params)):
        if k.endswith("conv/b"):
            assert np.abs(got - before[k]).max() <= JAX_OUTER_LR * (1 + 1e-5)
            continue
        np.testing.assert_allclose(got, want[k], rtol=0,
                                   atol=1e-5 * JAX_OUTER_LR, err_msg=k)


# --------------------------------------------------------------------------
# TRPO: the seeded outer step against jax.vmap(make_trpo_meta_step)
# --------------------------------------------------------------------------

B, E, T = 3, 4, 12
HIDDENS = (32, 32)
JCFG = jrl.RLConfig(inner_lr=0.05, adapt_steps=1, adapt_batch_size=E,
                    max_path_length=T)
TCFG = trl.RLConfig(inner_lr=0.05, adapt_steps=1, adapt_batch_size=E,
                    max_path_length=T)
TRPO = dict(outer_lr=0.1, max_kl=0.01, ls_max_steps=15,
            backtrack_factor=0.5, cg_iterations=10, damping=1e-5)


def _jax_seed_replays(seed):
    """Meta params, nearby collection-time adapted params and stacked
    replays of one seed, collected by JAX (``test_torch_train_scan.py``'s
    recipe) in float64 (under ``jax.enable_x64``)."""
    jpol = JPolicy(2, 2, hiddens=HIDDENS)
    # float64 params too (init draws float32): JAX's CG runs in their dtype
    jparams = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64),
                                     jpol.init(jax.random.key(seed)))
    goals = jnp.asarray(np.random.default_rng(seed).uniform(
        -0.3, 0.3, size=(B, 2)))
    roll = lambda p, g, k: jrollout(JEnv(), jpol.sample, p, g, k, E, T)
    keys = jax.random.split(jax.random.key(seed + 1), 2 * B).reshape(2, B)
    trajs = [jax.vmap(roll, (None, 0, 0))(jparams, goals, k) for k in keys]
    near = jax.tree_util.tree_map(
        lambda x: x + 0.01 * jax.random.normal(jax.random.key(seed + 3),
                                               x.shape), jparams)
    calls = iter(trajs)
    collect = jax.jit(jrl.trpo_collect_body(
        jpol, lambda p, t, k: jax.tree_util.tree_map(
            lambda x: x[t.astype(jnp.int32)], next(calls)), JCFG))
    jold, _, jrep, _ = collect(near, jnp.arange(B, dtype=jnp.float32),
                               jax.random.split(jax.random.key(seed + 2), B))
    return jparams, jold, jrep


@pytest.fixture(scope="module")
def seeded_outer():
    """S seeds' params, old params and replays collected by JAX in float64,
    stacked on a seed axis, and ``jax.vmap(make_trpo_meta_step)`` of them
    in float64: the reference. (JAX's float32 step lies 8-18 % of the step
    from it on these replays, the port's float32 step 0.3-0.7 %: f32 CG on
    a Fisher damped by 1e-5 amplifies rounding, ROADMAP Queue 3.)"""
    with jax.enable_x64(True):
        per_seed = [_jax_seed_replays(s) for s in SEEDS]
        stack = lambda *xs: jnp.stack(xs)
        jparams, jold, jrep = (jax.tree_util.tree_map(stack, *parts)
                               for parts in zip(*per_seed))
        jnew, jinfo = jax.vmap(jtm.make_trpo_meta_step(
            JPolicy(2, 2, hiddens=HIDDENS), JCFG, jtm.TRPOConfig(**TRPO),
            1))(jparams, jold, jrep)
        host = lambda t: jax.tree_util.tree_map(np.array, t)
        return tuple(map(host, (jparams, jold, jrep, jnew, jinfo)))


def _port_inputs(jparams, jold, jrep, dtype):
    """The JAX arrays folded seed-major into the task axis, floats in
    ``dtype``."""
    cast = lambda x: (torch.as_tensor(x, dtype=dtype)
                      if np.issubdtype(x.dtype, np.floating)
                      else torch.as_tensor(x))
    fold = lambda x: cast(x).flatten(0, 1)
    return (params_from_jax(jparams, "cpu", dtype=dtype),
            tree_map(fold, jold), Trajectory(*(fold(x) for x in jrep)))


def _vec(leaves):
    return np.concatenate([np.asarray(x, np.float64).ravel()
                           for x in leaves])


def test_seeded_trpo_step_matches_vmapped_jax_and_solo_steps(seeded_outer):
    jparams, jold, jrep, jnew, jinfo = seeded_outer
    pol = DiagNormalPolicy(2, 2, hiddens=HIDDENS)
    cfg = ttm.TRPOConfig(**TRPO)
    seeded_step = ttm.make_trpo_meta_step(pol, TCFG, cfg, 1, host_free=True,
                                          seeds=S)
    solo_step = ttm.make_trpo_meta_step(pol, TCFG, cfg, 1, host_free=True)
    new64, info64 = seeded_step(*_port_inputs(jparams, jold, jrep,
                                              torch.float64))
    params, old, rep = _port_inputs(jparams, jold, jrep, torch.float32)
    new, info = seeded_step(params, old, rep)
    assert info["old_loss"].shape == info["accepted"].shape == (S,)
    assert info["accepted"].tolist() == info64["accepted"].tolist() \
        == jinfo["accepted"].tolist() == [True, True]
    for i in range(S):
        want = _vec(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda x: x[i], jnew)))
        step = np.linalg.norm(want - _vec(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda x: x[i], jparams))))
        err64 = np.linalg.norm(_vec(tree_leaves(
            ms.seed_params(new64, i))) - want)
        assert err64 <= 1e-5 * step, err64 / step
        err32 = np.linalg.norm(_vec(tree_leaves(
            ms.seed_params(new, i))) - want)
        assert err32 <= 2e-2 * step, err32 / step
        rows = slice(i * B, (i + 1) * B)
        solo, sinfo = solo_step(ms.seed_params(params, i),
                                tree_map(lambda t: t[rows], old),
                                rep.map(lambda x: x[rows]))
        assert float(sinfo["old_loss"]) == float(info["old_loss"][i])
        for a, b in zip(tree_leaves(ms.seed_params(new, i)),
                        tree_leaves(solo)):
            assert torch.equal(a, b)


