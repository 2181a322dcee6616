"""Three small public functions of the JAX package and their ports, on the
same arrays: ``ops/cg.py:tree_hvp``, ``Trajectory.episode_success_steps``
and ``Experiment.save_acc_matrix``.

``tree_hvp``: the flat params in ``ravel_pytree``'s order, and the damped
Hessian-vector product of a smooth function of a nested params tree,
within float32 rounding (JAX forward-over-reverse, the port a double
backward). The other two are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from exploring_meta_tpu.ops import cg as jcg
from exploring_meta_tpu.rl.rollout import Trajectory as JTrajectory
from exploring_meta_tpu.utils.experiment import Experiment as JExperiment
from exploring_meta_tpu_torch.ops import cg as tcg
from exploring_meta_tpu_torch.rl.rollout import Trajectory
from exploring_meta_tpu_torch.utils.experiment import Experiment
from exploring_meta_tpu_torch.utils.tree import tree_items, tree_map


def _params(rng):
    """A nested tree with dict keys out of sorted order and a list."""
    return {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32),
            "layers": [{"scale": rng.normal(size=(4,)).astype(np.float32),
                        "bias": rng.normal(size=(4,)).astype(np.float32)}
                       for _ in range(2)]}


def _f(xp, tanh, p, x):
    h = tanh(x @ p["w"] + p["b"])
    for layer in p["layers"]:
        h = tanh(h * layer["scale"] + layer["bias"])
    return xp.sum(h ** 2) + 0.5 * xp.sum(p["w"] ** 2)


def test_tree_hvp_matches_jax():
    rng = np.random.default_rng(0)
    p = _params(rng)
    x = rng.normal(size=(5, 3)).astype(np.float32)
    jx = jnp.asarray(x)
    jAx, jflat, junravel = jcg.tree_hvp(
        lambda q: _f(jnp, jnp.tanh, q, jx), jax.tree_util.tree_map(
            jnp.asarray, p), damping=1e-3)
    tx = torch.as_tensor(x)
    tp = tree_map(torch.as_tensor, p)
    Ax, flat, unravel = tcg.tree_hvp(
        lambda q: _f(torch, torch.tanh, q, tx), tp, damping=1e-3)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    for seed in range(3):
        v = np.random.default_rng(seed + 1).normal(
            size=flat.shape).astype(np.float32)
        want = np.asarray(jAx(jnp.asarray(v)))
        got = Ax(torch.as_tensor(v)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    # unravel: the same leaves at the same paths as JAX's
    v = np.arange(flat.numel(), dtype=np.float32)
    got = dict(tree_items(unravel(torch.as_tensor(v))))
    want = junravel(jnp.asarray(v))
    jpaths = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path): leaf for path, leaf in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    assert set(got) == set(jpaths)
    for k, leaf in jpaths.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(leaf))
    assert ravel_pytree(want)[0].shape == (flat.numel(),)


def _trajectory(rng, lead=()):
    T, E = 7, 5
    success = (rng.random(lead + (T, E)) < 0.2).astype(np.float32)
    # episodes end early: steps after a random end are not valid
    ends = rng.integers(1, T + 1, size=lead + (E,))
    valid = (np.arange(T)[:, None] < ends[..., None, :]).astype(np.float32)
    z = np.zeros(lead + (T, E), np.float32)
    fields = dict(state=z[..., None], action=z[..., None], reward=z,
                  done=z, next_state=z[..., None], success=success,
                  valid=valid, timestep=z.astype(np.int32))
    return fields


@pytest.mark.parametrize("seed", range(4))
def test_episode_success_steps_matches_jax(seed):
    rng = np.random.default_rng(seed)
    fields = _trajectory(rng, lead=(3,))
    # one episode that never succeeds and one that succeeds only after
    # its end (not valid: no success)
    fields["success"][0, :, 0] = 0.0
    fields["valid"][1, 3:, 1] = 0.0
    fields["success"][1, :, 1] = 0.0
    fields["success"][1, 5, 1] = 1.0
    got = Trajectory(**{k: torch.as_tensor(v) for k, v in
                        fields.items()}).episode_success_steps()
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 5)
    for b in range(3):
        want = JTrajectory(**{k: jnp.asarray(v[b]) for k, v in
                              fields.items()}).episode_success_steps()
        assert want.dtype == jnp.int32
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
    assert int(got[0, 0]) == -1 and int(got[1, 1]) == -1


def test_save_acc_matrix_matches_jax(tmp_path, capsys):
    acc = np.random.default_rng(0).random((4, 4))
    jexp = JExperiment("maml_5w1s", "omni", {"seed": 1},
                       path=str(tmp_path / "jax") + "/")
    jexp.save_acc_matrix(acc)
    want_out = capsys.readouterr().out
    exp = Experiment("maml_5w1s", "omni", {"seed": 1},
                     path=str(tmp_path / "port") + "/")
    exp.save_acc_matrix(acc)
    got_out = capsys.readouterr().out
    assert got_out == want_out
    with open(f"{jexp.model_path}/acc_matrix.out") as f:
        want = f.read()
    with open(f"{exp.model_path}/acc_matrix.out") as f:
        got = f.read()
    assert got == want and len(want.splitlines()) == 4
