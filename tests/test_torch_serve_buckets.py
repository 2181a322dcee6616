"""Request buckets of the port's servers vs ``exploring_meta_tpu.serve``.

Both packages serve a batch of B requests as the program of B's bucket:
the next power of two, a multiple of a mesh's device count, reached by
repeating the first request. The port's ``_next_bucket`` and
``_pad_leading`` are held against JAX's; ragged batches (B = 3, 5, 7)
against per-request serving and against JAX's servers on the same params
and inputs, at ``tests/test_torch_serve.py``'s and
``tests/test_torch_policy_serve.py``'s tolerances (probabilities 1e-4
against JAX, 1e-5 against a request served alone; adapted params 1e-5 of
max|params|, actions 1e-6); a server mesh of 3 CPU "devices" at B = 5
(JAX's bucket: 8 rounded up to 9, three requests a device) against the
unsharded batch. On the CPU the servers run their buckets
eagerly (no CUDA graph); ``tests/test_torch_cuda.py`` holds the replays on
the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_meta_tpu import serve as jserve
from exploring_meta_tpu.envs.particles2d import Particles2D as JEnv
from exploring_meta_tpu.models import cnn4 as jc
from exploring_meta_tpu.models.policies import DiagNormalPolicy as JPolicy
from exploring_meta_tpu.rl import adapt_rl as jrl
from exploring_meta_tpu.rl.rollout import rollout as jrollout
from exploring_meta_tpu_torch import serve
from exploring_meta_tpu_torch.models import cnn4 as tcnn
from exploring_meta_tpu_torch.models import distributions as tdist
from exploring_meta_tpu_torch.models.policies import (
    CategoricalPolicy, DiagNormalPolicy,
)
from exploring_meta_tpu_torch.parallel import mesh as tmesh
from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig
from exploring_meta_tpu_torch.rl.rollout import Trajectory
from exploring_meta_tpu_torch.utils import graphs
from exploring_meta_tpu_torch.utils.bridge import params_from_jax
from exploring_meta_tpu_torch.utils.tree import (
    tree_items, tree_leaves, tree_map, tree_unflatten,
)

WAYS, SHOTS, Q = 5, 2, 6
N_MAX, E, T = 5, 4, 12
HIDDENS = (32, 32)
CFG = dict(inner_lr=0.1, adapt_steps=1, adapt_batch_size=E,
           max_path_length=T)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("B,multiple", [(1, 1), (5, 1), (7, 1), (8, 1),
                                        (9, 8), (5, 3), (4, 6), (63, 1),
                                        (64, 1), (65, 1)])
def test_next_bucket_is_jaxs(B, multiple):
    got = serve._next_bucket(B, multiple)
    assert got == jserve._next_bucket(B, multiple)
    assert got >= B and got % multiple == 0


def test_pad_leading_is_jaxs():
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(3, 2, 4)).astype(np.float32),
            "b": [rng.integers(0, 9, size=(3,)).astype(np.int32),
                  (rng.normal(size=(3, 5)).astype(np.float32),)]}
    want = jserve._pad_leading(jax.tree_util.tree_map(jnp.asarray, tree), 3)
    got = serve._pad_leading(tree_map(torch.as_tensor, tree), 3)
    assert len(tree_items(got)) == len(tree_items(want)) == 3
    for (kg, g), (kw, w) in zip(tree_items(got), tree_items(want)):
        assert kg == kw and g.dtype == torch.as_tensor(np.array(w)).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert serve._pad_leading(got, 0) is got


def _requests(seed, b):
    rng = np.random.default_rng(seed)
    sx = rng.normal(size=(b, SHOTS * WAYS, 28, 28, 1)).astype(np.float32)
    sy = np.tile(np.tile(np.arange(WAYS), SHOTS), (b, 1)).astype(np.int32)
    qx = rng.normal(size=(b, Q, 28, 28, 1)).astype(np.float32)
    return sx, sy, qx


def _vision_servers(anil):
    if anil:
        jspec = jc.anil_omniglot_spec(WAYS)
        tspec = tcnn.anil_omniglot_spec(WAYS)
    else:
        jspec = jc.omniglot_spec(WAYS, hidden=16)
        tspec = tcnn.omniglot_spec(WAYS, hidden=16)
    jparams = jc.init_cnn4(jax.random.key(0), jspec)
    kw = dict(inner_lr=0.5, adapt_steps=2, anil=anil)
    return (jserve.VisionServer(jspec, jparams, **kw),
            serve.VisionServer(tspec, params_from_jax(jparams, "cpu"),
                               device="cpu", **kw))


@pytest.mark.parametrize("B", [3, 5, 7])
@pytest.mark.parametrize("anil", [False, True], ids=["maml", "anil"])
def test_ragged_vision_batch(anil, B):
    """A ragged batch served as its bucket: each request as served alone,
    and JAX's padded batch."""
    jserver, tserver = _vision_servers(anil)
    sx, sy, qx = _requests(B, B)
    preds, probs = tserver.batch(sx, sy, qx)
    assert preds.shape == (B, Q) and probs.shape == (B, Q, WAYS)
    for i in range(B):
        p, q = tserver(sx[i], sy[i], qx[i])
        torch.testing.assert_close(p, preds[i], rtol=0, atol=0)
        torch.testing.assert_close(q, probs[i], rtol=1e-5, atol=1e-5)
    jpreds, jprobs = jserver.batch(jnp.asarray(sx), jnp.asarray(sy),
                                   jnp.asarray(qx))
    jprobs = np.asarray(jprobs)
    np.testing.assert_allclose(probs.numpy(), jprobs, rtol=1e-4, atol=1e-4)
    top2 = np.sort(jprobs, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-3
    np.testing.assert_array_equal(preds.numpy()[clear],
                                  np.asarray(jpreds)[clear])


@pytest.fixture(scope="module")
def supports():
    """JAX params and N_MAX support trajectories of Particles2D (numpy)
    stacked ``[N_MAX, T, E, ...]``, collected by the JAX rollout."""
    jpol = JPolicy(2, 2, hiddens=HIDDENS)
    params = jpol.init(jax.random.key(0))
    goals = jnp.asarray(np.random.default_rng(0).uniform(
        -0.3, 0.3, size=(N_MAX, 2)), jnp.float32)
    roll = jax.jit(lambda g, k: jrollout(JEnv(), jpol.sample, params, g, k,
                                         E, T))
    keys = jax.random.split(jax.random.key(2), N_MAX)
    trajs = [roll(goals[i], keys[i]) for i in range(N_MAX)]
    return params, jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trajs)


def _policy_servers(params, algo, **kw):
    kw = kw or {"device": "cpu"}
    cfg = dict(CFG)
    return (jserve.PolicyServer(JPolicy(2, 2, hiddens=HIDDENS), params,
                                jrl.RLConfig(**cfg), algo=algo),
            serve.PolicyServer(DiagNormalPolicy(2, 2, hiddens=HIDDENS),
                               params_from_jax(params, "cpu"),
                               RLConfig(**cfg), algo=algo, **kw))


def _held(got, want, rel):
    """``|got - want| <= rel * max|want|`` over the tree."""
    got = {k: np.asarray(v, np.float64) for k, v in tree_items(got)}
    want = {k: np.asarray(v, np.float64) for k, v in tree_items(want)}
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        assert np.abs(got[key] - w).max() <= rel * top, key


def _first(stack, n):
    return jax.tree_util.tree_map(lambda x: x[:n], stack)


@pytest.mark.parametrize("n", [3, 5])
@pytest.mark.parametrize("algo", ["vpg", "ppo", "trpo"])
def test_ragged_adapt_batched(supports, algo, n):
    params, stack = supports
    jserver, tserver = _policy_servers(params, algo)
    support = _first(stack, n)
    got = tserver.adapt_batched(support)
    assert all(v.shape[0] == n for _, v in tree_items(got))
    _held(got, jserver.adapt_batched(
        jax.tree_util.tree_map(jnp.asarray, support)), 1e-5)
    for i in range(n):
        one = tserver.adapt(jax.tree_util.tree_map(lambda x: x[i], support))
        _held(one, tree_map(lambda t: t[i], got), 1e-6)


def test_ragged_act_batched(supports):
    params, stack = supports
    jserver, tserver = _policy_servers(params, "ppo")
    support = _first(stack, 3)
    adapted = tserver.adapt_batched(support)
    jadapted = jserver.adapt_batched(
        jax.tree_util.tree_map(jnp.asarray, support))
    obs = np.arange(3 * 5 * 2, dtype=np.float32).reshape(3, 5, 2) / 10.0
    got = tserver.act_batched(adapted, obs)
    assert got.shape == (3, 5, 2)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jserver.act_batched(jadapted,
                                                    jnp.asarray(obs))),
        rtol=1e-6, atol=1e-6)
    # JAX's act_batched on the port's adapted params: the action fn alone
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jserver.act_batched(
            jax.tree_util.tree_map(jnp.asarray, tree_map(
                lambda t: t.numpy(), adapted)), jnp.asarray(obs))),
        rtol=1e-6, atol=1e-6)


def test_sample_batched_draws_for_the_bucket(supports):
    """One generator draws for the whole bucket (4 rows for 3 tasks): the
    rows served are the first rows of the bucket's draw."""
    params, stack = supports
    _, tserver = _policy_servers(params, "vpg")
    adapted = tserver.adapt_batched(_first(stack, 3))
    obs = torch.as_tensor(stack.state[:3, 0])
    got = tserver.sample_batched(adapted, torch.Generator().manual_seed(5),
                                 obs)
    padded = serve._pad_leading((adapted, obs), 1)
    want = tserver._draw(torch.Generator().manual_seed(5),
                         tserver._dist(*padded))
    assert got.shape == (3, E, 2) and torch.equal(got, want[:3])


def _recording_splits(monkeypatch) -> list:
    calls = []
    split = tmesh.split_requests

    def recording(mesh, n):
        out = split(mesh, n)
        calls.append((n, [b - a for _, a, b in out]))
        return out
    monkeypatch.setattr(serve, "split_requests", recording)
    return calls


def test_vision_mesh_of_3_serves_5_as_a_bucket_of_9(monkeypatch):
    spec = tcnn.omniglot_spec(WAYS, hidden=8, layers=2)
    params = tcnn.init_cnn4(torch.Generator().manual_seed(0), spec,
                            device="cpu")
    sx, sy, qx = _requests(9, 5)
    kw = dict(inner_lr=0.4, adapt_steps=1)
    want = serve.VisionServer(spec, params, device="cpu", **kw).batch(
        sx, sy, qx)
    calls = _recording_splits(monkeypatch)
    mesh = tmesh.make_task_mesh(devices=("cpu",) * 3)
    got = serve.VisionServer(spec, params, mesh=mesh, **kw).batch(sx, sy, qx)
    assert calls == [(9, [3, 3, 3])]
    assert got[1].shape == want[1].shape == (5, Q, WAYS)
    assert torch.equal(got[0], want[0])
    assert float((got[1] - want[1]).abs().max()) <= 1e-6 * float(
        want[1].abs().max())


def test_policy_mesh_of_3_serves_5_as_a_bucket_of_9(supports, monkeypatch):
    params, stack = supports
    _, plain = _policy_servers(params, "ppo", device="cpu")
    _, sharded = _policy_servers(params, "ppo", mesh=tmesh.make_task_mesh(
        devices=("cpu",) * 3))
    support = Trajectory(*(torch.as_tensor(x) for x in stack))
    calls = _recording_splits(monkeypatch)
    got = sharded.adapt_batched(support)
    assert calls == [(9, [3, 3, 3])]
    want = plain.adapt_batched(support)
    _held(got, want, 1e-6)
    obs = torch.as_tensor(stack.state[:, 0])
    a, b = sharded.act_batched(got, obs), plain.act_batched(want, obs)
    assert a.shape == (N_MAX, E, 2)
    assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


def test_captured_calls_run_eagerly_on_the_cpu():
    """On the CPU a captured call is the function itself: the first rows
    of its result, no graph kept, nothing counted."""
    calls = graphs.CapturedCalls()
    graphs.reset_counts()
    x = torch.arange(12.0).reshape(4, 3)
    traj = Trajectory(*(x.clone() for _ in Trajectory._fields))
    out = calls("double", lambda t, y: (2 * t.reward, {"y": y + 1}),
                (traj, x), rows=3)
    assert torch.equal(out[0], 2 * x[:3]) and torch.equal(out[1]["y"],
                                                           x[:3] + 1)
    assert calls.graphs == {} and calls.pool is None
    assert graphs.COUNTS == {"captures": 0, "replays": 0}
    with graphs.run_eagerly():
        assert torch.equal(calls("double", lambda t: t * 2, (x,)), 2 * x)
    with pytest.raises(TypeError, match="tensors"):
        calls("bad", lambda t: t, (3,))
    gen = torch.Generator()
    drawn = calls("draw", lambda g, t: t + torch.randn(t.shape, generator=g),
                  (x,), rows=2, generator=gen.manual_seed(3))
    want = x + torch.randn(x.shape, generator=torch.Generator().manual_seed(3))
    assert torch.equal(drawn, want[:2])


@pytest.mark.parametrize("shape", [(5, 4), (3, 7, 4), (2, 3, 50, 6)])
def test_categorical_draw_is_multinomials(shape):
    """The categorical draw (an exponential race, capturable) is
    torch.multinomial's one-draw path: the same categories from the same
    generator state."""
    logits = 2 * torch.randn(shape, generator=torch.Generator().manual_seed(0))
    got = tdist.categorical_sample(torch.Generator().manual_seed(1), logits)
    probs = torch.softmax(logits, -1).reshape(-1, shape[-1])
    want = torch.multinomial(probs, 1, generator=torch.Generator()
                             .manual_seed(1))
    assert got.shape == shape[:-1]
    assert torch.equal(got, want.reshape(shape[:-1]))


def test_categorical_sample_batched_draws_for_the_bucket():
    """A categorical fleet of 3 draws over its bucket of 4; the log-probs
    are the draws'; act_batched is the logits' argmax."""
    cat = CategoricalPolicy(6, 3, hiddens=(8,))
    params = cat.init(torch.Generator().manual_seed(0), device="cpu")
    server = serve.PolicyServer(cat, params, RLConfig(), device="cpu")
    g = torch.Generator().manual_seed(1)
    fleet = tree_map(lambda t: t + 0.3 * torch.randn(
        (3,) + tuple(t.shape), generator=g), params)
    states = torch.randint(0, 6, (3, 5), generator=g)
    action, info = server.sample_batched(fleet, g.manual_seed(2), states)
    logits = cat.logits(fleet, states)
    padded = serve._pad_leading((fleet, states), 1)
    want = tdist.categorical_sample(g.manual_seed(2), cat.logits(*padded))
    assert action.shape == (3, 5) and torch.equal(action, want[:3])
    torch.testing.assert_close(info["log_prob"], tdist.categorical_log_prob(
        logits, action), rtol=0, atol=1e-6)
    assert torch.equal(server.act_batched(fleet, states), logits.argmax(-1))


def test_tree_map_rebuilds_named_tuples():
    traj = Trajectory(*(torch.full((2,), float(i))
                        for i in range(len(Trajectory._fields))))
    doubled = tree_map(lambda a, b: a + b, {"t": traj}, {"t": traj})
    assert type(doubled["t"]) is Trajectory
    assert [float(x[0]) for x in doubled["t"]] == [
        2.0 * i for i in range(len(Trajectory._fields))]
    rebuilt = tree_unflatten(traj, tree_leaves(doubled["t"]))
    assert type(rebuilt) is Trajectory
    assert all(a is b for a, b in zip(rebuilt, doubled["t"]))
