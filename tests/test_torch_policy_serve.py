"""PolicyServer of the PyTorch port vs ``exploring_meta_tpu.serve``, on the
CPU.

Both servers get the same params (bridged from JAX) and the same support
trajectories, collected by the JAX rollout on three Particles2D tasks and
passed as numpy. Small size: E = 4 episodes, T = 12 steps, hiddens (32,
32). Adapted params are held within 1e-5 of max|params| over the tree
(the linear baseline's ill-conditioned f32 solve moves the inner step by
~1e-4 of itself, tests/test_torch_rl_trpo.py, and a zero-initialized
bias holds only its step); actions within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_meta_tpu.envs.particles2d import Particles2D as JEnv
from exploring_meta_tpu.models.policies import CategoricalPolicy as JCat
from exploring_meta_tpu.models.policies import DiagNormalPolicy as JPolicy
from exploring_meta_tpu.models.policies import DiagNormalPolicyANIL as JANIL
from exploring_meta_tpu.rl import adapt_rl as jrl
from exploring_meta_tpu.rl.rollout import rollout as jrollout
from exploring_meta_tpu.serve import PolicyServer as JServer
from exploring_meta_tpu.utils.experiment import flatten_params as jflatten
from exploring_meta_tpu_torch.models.policies import (
    CategoricalPolicy, DiagNormalPolicy, DiagNormalPolicyANIL,
)
from exploring_meta_tpu_torch.parallel.mesh import TaskMesh, make_task_mesh
from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig
from exploring_meta_tpu_torch.serve import PolicyServer
from exploring_meta_tpu_torch.utils.bridge import params_from_jax
from exploring_meta_tpu_torch.utils.tree import tree_items, tree_map

N, E, T = 3, 4, 12
HIDDENS = (32, 32)
CFG = dict(inner_lr=0.1, adapt_steps=1, adapt_batch_size=E,
           max_path_length=T)
REL = 1e-5


def _policies(anil: bool):
    if anil:
        return (JANIL(2, 2, fc_neurons=HIDDENS[-1], hiddens=HIDDENS),
                DiagNormalPolicyANIL(2, 2, fc_neurons=HIDDENS[-1],
                                     hiddens=HIDDENS))
    return JPolicy(2, 2, hiddens=HIDDENS), DiagNormalPolicy(2, 2,
                                                            hiddens=HIDDENS)


@pytest.fixture(scope="module")
def setup():
    """JAX params of both policies, and N support trajectories (numpy)
    stacked ``[N, T, E, ...]``."""
    jpol, _ = _policies(False)
    params = {False: jpol.init(jax.random.key(0)),
              True: _policies(True)[0].init(jax.random.key(1))}
    goals = jnp.asarray(np.random.default_rng(0).uniform(
        -0.3, 0.3, size=(N, 2)), jnp.float32)
    roll = jax.jit(lambda g, k: jrollout(JEnv(), jpol.sample, params[False],
                                         g, k, E, T))
    keys = jax.random.split(jax.random.key(2), N)
    trajs = [roll(goals[i], keys[i]) for i in range(N)]
    stack = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trajs)
    return params, stack


def _servers(params, anil, algo, **cfg):
    jpol, tpol = _policies(anil)
    jserver = JServer(jpol, params[anil], jrl.RLConfig(**{**CFG, **cfg},
                                                       anil=anil), algo=algo)
    tserver = PolicyServer(tpol, params_from_jax(params[anil], "cpu"),
                           RLConfig(**{**CFG, **cfg}, anil=anil), algo=algo,
                           device="cpu")
    return jserver, tserver


def _items(tree) -> dict:
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v,
                          np.float64) for k, v in tree_items(tree)}


def _held(got, want, rel=REL):
    """``|got - want| <= rel * max|want|``, the max over every leaf: a
    zero-initialized bias holds only the step, a sum that cancels."""
    got, want = _items(got), _items(want)
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        err = np.abs(got[key] - w).max()
        assert err <= rel * top, (key, err, top)


def _one(stack, i):
    return jax.tree_util.tree_map(lambda x: x[i], stack)


@pytest.mark.parametrize("anil", [False, True])
@pytest.mark.parametrize("algo", ["vpg", "ppo", "trpo"])
def test_adapt_matches_jax_server(setup, algo, anil):
    params, stack = setup
    jserver, tserver = _servers(params, anil, algo)
    support = _one(stack, 0)
    got = tserver.adapt(support)
    _held(got, jserver.adapt(jax.tree_util.tree_map(jnp.asarray, support)))
    before, after = _items(tserver.params), _items(got)
    for key in before:
        moved = np.abs(after[key] - before[key]).max()
        if anil and key.startswith("body"):
            assert moved == 0, key        # the body is bit-for-bit kept
        else:
            assert moved > 0, key


@pytest.mark.parametrize("algo", ["vpg", "ppo", "trpo"])
def test_adapt_batched_matches_jax_and_per_request_adapt(setup, algo):
    params, stack = setup
    jserver, tserver = _servers(params, False, algo, adapt_steps=2)
    got = tserver.adapt_batched(stack)
    assert all(v.shape[0] == N and not v.requires_grad
               for _, v in tree_items(got))
    _held(got, jserver.adapt_batched(
        jax.tree_util.tree_map(jnp.asarray, stack)))
    for i in range(N):
        one = tserver.adapt(_one(stack, i))        # the same 2-step budget
        _held(one, tree_map(lambda t: t[i], got), 1e-6)


def test_zero_steps_return_the_meta_params(setup):
    params, stack = setup
    _, tserver = _servers(params, False, "vpg")
    for key, v in tree_items(tserver.adapt(_one(stack, 0), steps=0)):
        assert torch.equal(v, dict(tree_items(tserver.params))[key])
    batched = tserver.adapt_batched(stack, steps=0)
    assert all(v.shape[0] == N for _, v in tree_items(batched))


def test_actions(setup):
    params, stack = setup
    jserver, tserver = _servers(params, False, "ppo")
    adapted = tserver.adapt_batched(stack)
    obs = np.arange(N * 5 * 2, dtype=np.float32).reshape(N, 5, 2) / 10.0
    fleet = tserver.act_batched(adapted, obs)
    assert fleet.shape == (N, 5, 2)
    for i in range(N):
        one = tree_map(lambda t: t[i], adapted)
        np.testing.assert_allclose(fleet[i].numpy(),
                                   tserver.act(one, obs[i]).numpy(),
                                   rtol=1e-6, atol=1e-6)
    # the deterministic action is the Gaussian mean, as JAX's
    want = jserver.act(params[False], jnp.asarray(obs[0]))
    np.testing.assert_allclose(tserver.act(tserver.params, obs[0]).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    assert tserver.sample_batched(adapted, gen, obs).shape == (N, 5, 2)
    assert tserver.sample(tserver.params, gen, obs[0]).shape == (5, 2)


def test_from_checkpoint_reads_a_jax_model(setup, tmp_path):
    params, stack = setup
    for anil in (False, True):
        jpol, tpol = _policies(anil)
        path = str(tmp_path / f"model_{anil}.npz")
        np.savez(path, **{k: np.asarray(v)
                          for k, v in jflatten(params[anil]).items()})
        cfg = RLConfig(**CFG, anil=anil)
        loaded = PolicyServer.from_checkpoint(path, tpol, cfg, algo="vpg",
                                              device="cpu")
        fresh = PolicyServer(tpol, params_from_jax(params[anil], "cpu"), cfg,
                             algo="vpg", device="cpu")
        for (k, a), (_, b) in zip(tree_items(loaded.adapt(_one(stack, 1))),
                                  tree_items(fresh.adapt(_one(stack, 1)))):
            assert torch.equal(a, b), k


def test_refusals(setup):
    """An unknown algo and a rank's mesh are refused; a server mesh and a
    policy without ``density`` are served (since the scale-out slice:
    ``test_torch_mesh.py``, ``test_torch_policies_cnn.py``)."""
    params, _ = setup
    _, tpol = _policies(False)
    tparams = params_from_jax(params[False], "cpu")
    cfg = RLConfig(**CFG)
    with pytest.raises(ValueError, match="sgd"):
        PolicyServer(tpol, tparams, cfg, algo="sgd", device="cpu")
    with pytest.raises(ValueError, match="server mesh"):
        PolicyServer(tpol, tparams, cfg, mesh=TaskMesh(["cpu"] * 2, rank=0))
    served = PolicyServer(tpol, tparams, cfg, mesh=make_task_mesh(
        devices=("cpu", "cpu")))
    assert served.device.type == "cpu" and served.mesh.size == 2
    jcat = JCat(4, 2, hiddens=(8,))
    cat = PolicyServer(CategoricalPolicy(4, 2, hiddens=(8,)),
                       params_from_jax(jcat.init(jax.random.key(0)), "cpu"),
                       cfg, device="cpu")
    assert cat.act(cat.params, np.arange(4)).shape == (4,)
    if torch.cuda.is_available():
        assert PolicyServer(tpol, tparams, cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PolicyServer(tpol, tparams, cfg)
