"""Task data parallelism of the PyTorch port (``parallel/mesh.py``,
``parallel/launch.py``) vs the JAX package's mesh, on the CPU.

The port runs two gloo ranks on the CPU (one launch, whose ranks run
``tests/torch_mesh_workers.py:sharded_step_checks``); JAX runs on 2 of its 8
virtual CPU devices (``eight_devices``). Both get the same inputs: JAX's
sampled task batch and JAX's replays; where a rank samples its own tasks
(the fused scans), each rank records what it drew and the test rebuilds
the unsharded step on the concatenation.

Tolerances, each that of the unsharded test of the same step:
- vision meta-gradients: 3e-4 relative / 3e-5 of max|grad| a leaf against
  JAX, conv biases (zero in exact arithmetic) by magnitude
  (``test_torch_vision_meta.py``); against the port's unsharded step on
  the same batch 1e-5 of max|grad| a leaf; an Adam step within 1e-5 lr
  wherever the gradient is above its noise (Adam's first step is the sign
  of the gradient, so an element within rounding of 0 may flip: those
  move at most 2 lr);
- the TRPO outer step: 2e-2 of the step, the same line-search outcome
  (``test_torch_rl_trpo.py``);
- PPO replay meta-gradients: 1e-4 of max|grad| a leaf against JAX
  (``test_torch_rl_replay.py``), 1e-5 against the unsharded port;
- losses 1e-5 relative, or 1e-6 absolute where they cancel (PPO's query
  loss is 0 up to rounding).

Every rank's params are bitwise equal after every iteration
(``replicated_equal``). The TRPO and replay steps are held against both
JAX's unsharded step and its sharded one (``tests/test_mesh.py`` marks
its own sharded-vs-unsharded checks ``slow``; at these sizes JAX compiles
them in a few seconds here).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

from exploring_meta_tpu import adapt as jadapt
from exploring_meta_tpu import models as jmodels
from exploring_meta_tpu import parallel as jparallel
from exploring_meta_tpu import rl as jrl
from exploring_meta_tpu import tasks as jtasks
from exploring_meta_tpu.envs import Particles2D as JEnv
from exploring_meta_tpu.models import DiagNormalPolicy as JPolicy
from exploring_meta_tpu_torch.adapt.maml import (
    adam, make_meta_eval, make_meta_step,
)
from exploring_meta_tpu_torch.models import cnn4 as tcnn
from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
from exploring_meta_tpu_torch.parallel import launch as tlaunch
from exploring_meta_tpu_torch.parallel import mesh as tmesh
from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig, make_trpo_collect
from exploring_meta_tpu_torch.rl.replay_meta import (
    make_replay_meta_loss, replay_feeder,
)
from exploring_meta_tpu_torch.rl.trpo_meta import (
    TRPOConfig, make_trpo_meta_step,
)
from exploring_meta_tpu_torch.serve import PolicyServer, VisionServer
from exploring_meta_tpu_torch.utils.bridge import params_to_numpy
from exploring_meta_tpu_torch.utils.tree import (
    tree_items, tree_leaves, tree_map,
)

import torch_mesh_workers as W

SPEC = dict(ways=5, hidden=8, layers=2)
# the Adam steps at lr 0.1: 1e-5 lr lies above the float32 rounding of
# the params
VISION_B, VISION_LR, INNER_LR = 4, 0.1, 0.4
RL_CFG = dict(inner_lr=0.05, adapt_steps=1, adapt_batch_size=4,
              max_path_length=10, ppo_epochs=2)
TRPO = dict(outer_lr=0.1, max_kl=0.01, ls_max_steps=15,
            backtrack_factor=0.5, cg_iterations=10, damping=1e-5)
SCAN_CFG = dict(inner_lr=0.05, adapt_steps=1, adapt_batch_size=2,
                max_path_length=5, ppo_epochs=2)
N_TASKS, PPO_LR = 4, 0.1


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _stack(trees):
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)


def _cat(trees):
    return jax.tree_util.tree_map(lambda *xs: np.concatenate(xs), *trees)


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(v, np.float64).ravel()
                           for _, v in tree_items(tree)])


def _t(tree, grad=False):
    return tree_map(lambda a: torch.tensor(np.asarray(a)).requires_grad_(grad),
                    tree)


def _grads_held(got, want, rel, bias_by_magnitude=False):
    want = dict(tree_items(want))
    for key, g in tree_items(got):
        g, w = np.asarray(g, np.float64), np.asarray(want[key], np.float64)
        if bias_by_magnitude and key.endswith("conv/b"):
            assert np.abs(g).max() < 1e-4 and np.abs(w).max() < 1e-4, key
            continue
        assert np.abs(g - w).max() <= rel * np.abs(w).max(), (
            key, np.abs(g - w).max() / np.abs(w).max())


def _adam_held(got, want, grads, lr):
    """An Adam step held within 1e-5 lr where the reference gradient is
    above 1e-4 of its leaf's max; noise-level elements, and the conv
    biases, whose gradient is zero in exact arithmetic, may flip sign:
    within 2 lr."""
    want, grads = dict(tree_items(want)), dict(tree_items(grads))
    for key, p in tree_items(got):
        d = np.abs(np.asarray(p, np.float64) - np.asarray(want[key]))
        g = np.abs(np.asarray(grads[key]))
        big = (g > 1e-4 * g.max()) & (not key.endswith("conv/b"))
        assert d[big].max(initial=0) <= 1e-5 * lr, (key, d[big].max())
        assert d.max() <= 2 * lr * (1 + 1e-5), key


def _trpo_held(got, want, start, what):
    step = _flat(want) - _flat(start)
    assert np.linalg.norm(step) > 1e-3
    err = np.linalg.norm(_flat(got) - _flat(want))
    assert err <= 2e-2 * np.linalg.norm(step), (what, err
                                                / np.linalg.norm(step))


# -- inputs, JAX's references, and one launch of two ranks -----------------

@pytest.fixture(scope="module")
def inputs():
    """JAX's task batch and replays, the params, as numpy."""
    train, _, _ = jtasks.load_omniglot(seed=0, synthetic=True,
                                       synthetic_classes=20)
    data, labels = jtasks.sample_task_batch(jax.random.key(3), train, 5, 1,
                                            VISION_B)
    vparams = params_to_numpy(tcnn.init_cnn4(
        torch.Generator().manual_seed(0), tcnn.omniglot_spec(**SPEC),
        device="cpu"))

    jpol = JPolicy(2, 2, hiddens=W.HIDDENS)
    params = _np(jpol.init(jax.random.key(0)))
    # TRPO's replays and old params come from a nearby policy, so that the
    # surrogate and the KL are not 0 at the params (test_torch_rl_trpo.py)
    near = _np(jax.tree_util.tree_map(
        lambda x: x + 0.01 * jax.random.normal(jax.random.key(3), x.shape),
        params))
    cfg = jrl.RLConfig(**RL_CFG)
    roll = jrl.make_rollout(JEnv(), jpol.sample, episodes=4, horizon=10)
    trpo_collect = jax.jit(lambda p, t, k: jrl.fast_adapt_trpo(
        jpol, p, roll, t, k, cfg))
    ppo_collect = jax.jit(lambda p, t, k: jrl.collect_replays(
        "ppo", jpol, p, roll, t, k, cfg)[0])
    key = jax.random.key(1)
    replays, old, ppo = [], [], []
    for _ in range(N_TASKS):
        key, kt, ka, kc = jax.random.split(key, 4)
        task = JEnv().sample_tasks(kt, 1)[0]
        adapted, _, rep, _ = trpo_collect(near, task, ka)
        replays.append(rep)
        old.append(adapted)
        ppo.append(ppo_collect(params, task, kc))
    # the fused scan steps from a shifted point: at the collection params
    # the TRPO problem is f32-noise-dominated (tests/test_mesh.py)
    shifted = jax.tree_util.tree_map(lambda x: x * 1.1 + 0.02, params)
    return {
        "vision": {"spec": SPEC, "inner_lr": INNER_LR, "lr": VISION_LR,
                   "params": vparams, "data": np.asarray(data),
                   "labels": np.asarray(labels), "meta_batch": VISION_B},
        "trpo": {"cfg": RL_CFG, "trpo": TRPO, "params": params,
                 "old": _np(_stack(old)),
                 "replays": tuple(np.asarray(x) for x in
                                  jrl.stack_replays(replays))},
        "ppo": {"cfg": RL_CFG, "lr": PPO_LR, "params": params,
                "replays": tuple(np.asarray(x) for x in _stack(ppo))},
        "trpo_scan": {"cfg": SCAN_CFG, "trpo": TRPO, "params": _np(shifted),
                      "meta_batch": N_TASKS},
        "ppo_scan": {"cfg": SCAN_CFG, "lr": PPO_LR, "params": params,
                     "meta_batch": N_TASKS},
    }


@pytest.fixture(scope="module")
def ranks(inputs):
    start = time.perf_counter()
    outs = tlaunch.launch(W.sharded_step_checks, 2, args=(inputs,),
                          device="cpu")
    print(f"two gloo ranks: {time.perf_counter() - start:.1f} s")
    return [o["result"] for o in outs]


def _port_vision_step(v, data, labels):
    fa = W.vision_fast_adapt(v["spec"], v["inner_lr"])
    params = _t(v["params"], grad=True)
    _, _, m = make_meta_step(fa)(params, adam(params, v["lr"]),
                                 torch.as_tensor(data),
                                 torch.as_tensor(labels).long())
    return W.grads_of(params), W.numpy_tree(params), m


def _jax_vision(v, data, labels, sharded: bool):
    jspec = jmodels.omniglot_spec(**SPEC)
    fa = jadapt.make_vision_fast_adapt(jspec, inner_lr=INNER_LR,
                                       adapt_steps=1, shots=1, ways=5)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    opt = optax.adam(VISION_LR)
    if sharded:
        mesh = jparallel.make_task_mesh(2)
        step = jparallel.make_sharded_meta_step(fa, opt, mesh)
        sd, sl = jparallel.shard_task_batch(mesh, (jnp.asarray(data),
                                                   jnp.asarray(labels)))
        new, _, m = step(params, opt.init(params), sd, sl)
        return _np(new), float(m["loss"])

    def batch_loss(p):
        res = jax.vmap(lambda d, l: fa(p, d, l))(jnp.asarray(data),
                                                 jnp.asarray(labels))
        return jnp.mean(res.loss)
    return _np(jax.grad(batch_loss)(params))


# -- the vision factories ---------------------------------------------------

def test_sharded_meta_step_matches_jax_and_the_unsharded_step(ranks, inputs,
                                                             eight_devices):
    v = inputs["vision"]
    r0, r1 = (r["vision_step"] for r in ranks)
    assert r0["equal"] and r1["equal"]
    assert (ranks[0]["rank"], ranks[1]["rank"], ranks[0]["size"]) == (0, 1, 2)
    grads, params, m = _port_vision_step(v, v["data"], v["labels"])
    _grads_held(r0["grads"], grads, 1e-5, bias_by_magnitude=True)
    _adam_held(r0["params"], params, grads, VISION_LR)
    assert r0["loss"] == pytest.approx(float(m["loss"]), rel=1e-5)
    assert r0["metric"] == pytest.approx(float(m["metric"]), abs=1e-6)
    # against JAX: its gradient on the whole batch, its sharded Adam step
    jgrads = _jax_vision(v, v["data"], v["labels"], sharded=False)
    _grads_held(r0["grads"], jgrads, 3e-4, bias_by_magnitude=True)
    jnew, jloss = _jax_vision(v, v["data"], v["labels"], sharded=True)
    _adam_held(r0["params"], jnew, jgrads, VISION_LR)
    assert r0["loss"] == pytest.approx(jloss, rel=1e-5)


def test_sharded_train_scan_equals_the_step_on_the_ranks_batches(ranks,
                                                                 inputs):
    """Each rank draws its share from its own generator; the reduced step
    is the unsharded step on the concatenation of the shares (JAX's
    ``test_sharded_train_scan_equals_global_step``)."""
    v = inputs["vision"]
    r0, r1 = (r["vision_scan"] for r in ranks)
    assert all(r0["equal"]) and len(r0["equal"]) == 3
    assert not np.array_equal(r0["batch"][0], r1["batch"][0])
    data = np.concatenate([r0["batch"][0], r1["batch"][0]])
    labels = np.concatenate([r0["batch"][1], r1["batch"][1]])
    grads, params, m = _port_vision_step(v, data, labels)
    _grads_held(r0["grads"], grads, 1e-5, bias_by_magnitude=True)
    _adam_held(r0["params"], params, grads, VISION_LR)
    assert r0["metrics"]["loss"] == pytest.approx(float(m["loss"]), rel=1e-5)
    assert r0["metrics"] == r1["metrics"]
    assert set(r0["metrics"]) == {"loss", "metric", "valid_loss",
                                  "valid_metric"}


def test_sharded_meta_eval_is_the_mean_over_the_ranks(ranks, inputs):
    v = inputs["vision"]
    want = make_meta_eval(W.vision_fast_adapt(v["spec"], v["inner_lr"]))(
        _t(v["params"]), torch.as_tensor(v["data"]),
        torch.as_tensor(v["labels"]).long())
    got = ranks[0]["meta_eval"]
    assert got == ranks[1]["meta_eval"]
    assert got["loss"] == pytest.approx(float(want["loss"]), rel=1e-5)
    assert got["metric"] == pytest.approx(float(want["metric"]), abs=1e-6)


# -- the TRPO factories -----------------------------------------------------

@pytest.fixture(scope="module")
def jax_trpo(inputs):
    """JAX's unsharded TRPO step on the replays -> (params, accepted)."""
    r = inputs["trpo"]
    step = jrl.make_trpo_meta_step(JPolicy(2, 2, hiddens=W.HIDDENS),
                                   jrl.RLConfig(**RL_CFG),
                                   jrl.TRPOConfig(**TRPO), adapt_steps=1)
    jnew, jinfo = step(r["params"], r["old"], jrl.Trajectory(*r["replays"]))
    return _np(jnew), bool(jinfo["accepted"])


@pytest.mark.parametrize("host_free", [False, True])
def test_sharded_trpo_step_matches_the_unsharded_step_and_jax(ranks, inputs,
                                                             jax_trpo,
                                                             host_free):
    r = inputs["trpo"]
    got = ranks[0][f"trpo_step_{host_free}"]
    assert got["equal"] and ranks[1][f"trpo_step_{host_free}"]["equal"]
    policy = DiagNormalPolicy(2, 2, hiddens=W.HIDDENS)
    new, info = make_trpo_meta_step(
        policy, RLConfig(**RL_CFG), TRPOConfig(**TRPO), 1,
        host_free=host_free)(_t(r["params"]), _t(r["old"]),
                             W.traj(r["replays"]))
    assert got["accepted"] == bool(info["accepted"]) is True
    assert got["index"] == info.get("index")
    assert got["old_loss"] == pytest.approx(float(info["old_loss"]),
                                            rel=1e-5, abs=1e-7)
    _trpo_held(got["params"], W.numpy_tree(new), r["params"], "port")
    jnew, jaccepted = jax_trpo
    assert jaccepted == got["accepted"]
    _trpo_held(got["params"], jnew, r["params"], "jax")


def test_sharded_trpo_step_matches_jax_sharded(ranks, inputs, eight_devices):
    r = inputs["trpo"]
    jpol = JPolicy(2, 2, hiddens=W.HIDDENS)
    mesh = jparallel.make_task_mesh(2)
    step = jparallel.make_sharded_trpo_meta_step(
        jpol, jrl.RLConfig(**RL_CFG), jrl.TRPOConfig(**TRPO), 1, mesh)
    s_old, s_rep = jparallel.shard_task_batch(
        mesh, (r["old"], jrl.Trajectory(*r["replays"])))
    jnew, jinfo = step(r["params"], s_old, s_rep)
    got = ranks[0]["trpo_step_False"]
    assert bool(jinfo["accepted"]) == got["accepted"]
    assert got["old_loss"] == pytest.approx(float(jinfo["old_loss"]),
                                            rel=1e-4, abs=1e-6)
    _trpo_held(got["params"], _np(jnew), r["params"], "jax sharded")


def test_sharded_trpo_scan_equals_the_step_on_the_ranks_tasks(ranks, inputs):
    """Each rank collects its own tasks; the outer step is the unsharded
    one on the concatenated replays (JAX's
    ``test_sharded_trpo_train_scan_equals_unsharded``)."""
    s = inputs["trpo_scan"]
    r0, r1 = (r["trpo_scan"] for r in ranks)
    assert all(r0["equal"]) and r0["metrics"] == r1["metrics"]
    policy = DiagNormalPolicy(2, 2, hiddens=W.HIDDENS)
    cfg = RLConfig(**SCAN_CFG)
    olds, reps = [], []
    for r in (r0, r1):
        rep = W.traj(r["replays"])
        old = make_trpo_collect(policy, replay_feeder(rep), cfg)(
            _t(s["params"]), rep.reward.new_zeros(rep.reward.shape[0]),
            None)[0]
        olds.append(W.numpy_tree(old))
        reps.append(r["replays"])
    new, info = make_trpo_meta_step(policy, cfg, TRPOConfig(**TRPO), 1,
                                    host_free=True)(
        _t(s["params"]), _t(_cat(olds)), W.traj(_cat(reps)))
    assert r0["metrics"]["ls_accepted"] == float(info["accepted"])
    assert r0["metrics"]["meta_loss"] == pytest.approx(
        float(info["old_loss"]), rel=1e-5, abs=1e-7)
    query = W.traj(_cat(reps)).map(lambda x: x[:, -1])
    reward = float(((query.reward * query.valid).flatten(1).sum(1)
                    / query.n_episodes).mean())
    assert r0["metrics"]["adapt_reward"] == pytest.approx(reward, rel=1e-5)
    _trpo_held(r0["params"], W.numpy_tree(new), s["params"], "scan")


# -- the Adam factories -----------------------------------------------------

def _replay_grads(params_np, replays, lr):
    params = _t(params_np, grad=True)
    opt = adam(params, lr)
    loss = make_replay_meta_loss("ppo", DiagNormalPolicy(
        2, 2, hiddens=W.HIDDENS), RLConfig(**RL_CFG))(params,
                                                      W.traj(replays))
    from exploring_meta_tpu_torch.adapt.maml import apply_meta_gradient
    apply_meta_gradient(opt, loss, params)
    return W.grads_of(params), W.numpy_tree(params), float(loss)


def test_sharded_replay_step_matches_the_unsharded_step_and_jax(ranks,
                                                               inputs):
    p = inputs["ppo"]
    got = ranks[0]["replay_step"]
    assert got["equal"] and ranks[1]["replay_step"]["equal"]
    grads, params, loss = _replay_grads(p["params"], p["replays"], PPO_LR)
    _grads_held(got["grads"], grads, 1e-5)
    _adam_held(got["params"], params, grads, PPO_LR)
    assert got["loss"] == pytest.approx(loss, abs=1e-6)
    jpol = JPolicy(2, 2, hiddens=W.HIDDENS)
    jloss, jgrads = jax.jit(jax.value_and_grad(jrl.make_replay_meta_loss(
        "ppo", jpol, jrl.RLConfig(**RL_CFG))))(
        p["params"], jrl.Trajectory(*p["replays"]))
    _grads_held(got["grads"], _np(jgrads), 1e-4)
    assert got["loss"] == pytest.approx(float(jloss), abs=1e-6)


def test_sharded_replay_step_matches_jax_sharded(ranks, inputs,
                                                 eight_devices):
    p = inputs["ppo"]
    jpol = JPolicy(2, 2, hiddens=W.HIDDENS)
    opt = optax.adam(PPO_LR)
    mesh = jparallel.make_task_mesh(2)
    step = jparallel.make_sharded_replay_meta_step(
        jpol, jrl.RLConfig(**RL_CFG), "ppo", opt, mesh)
    rep = jparallel.shard_task_batch(mesh, jrl.Trajectory(*p["replays"]))
    jnew, _, jloss = step(p["params"], opt.init(p["params"]), rep)
    grads, _, _ = _replay_grads(p["params"], p["replays"], PPO_LR)
    got = ranks[0]["replay_step"]
    _adam_held(got["params"], _np(jnew), grads, PPO_LR)
    assert got["loss"] == pytest.approx(float(jloss), abs=1e-6)


def test_sharded_adam_scan_equals_the_step_on_the_ranks_tasks(ranks, inputs):
    s = inputs["ppo_scan"]
    r0, r1 = (r["ppo_scan"] for r in ranks)
    assert all(r0["equal"]) and r0["metrics"] == r1["metrics"]
    replays = _cat([r0["replays"], r1["replays"]])
    params = _t(s["params"], grad=True)
    opt = adam(params, PPO_LR)
    loss = make_replay_meta_loss("ppo", DiagNormalPolicy(
        2, 2, hiddens=W.HIDDENS), RLConfig(**SCAN_CFG))(params,
                                                        W.traj(replays))
    from exploring_meta_tpu_torch.adapt.maml import apply_meta_gradient
    apply_meta_gradient(opt, loss, params)
    grads = W.grads_of(params)
    _grads_held(r0["grads"], grads, 1e-5)
    _adam_held(r0["params"], W.numpy_tree(params), grads, PPO_LR)
    assert r0["metrics"]["meta_loss"] == pytest.approx(float(loss), abs=1e-6)
    assert set(r0["metrics"]) == {"meta_loss", "adapt_reward",
                                  "adapt_success"}


# -- the mesh and the launcher ---------------------------------------------

def test_make_task_mesh_rejects_oversized_request(eight_devices):
    """As JAX's: a mesh larger than the machine raises, never truncates."""
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="devices are available"):
        tmesh.make_task_mesh(n)
    with pytest.raises(ValueError, match="devices are available"):
        jparallel.make_task_mesh(len(jax.devices()) + 1)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="devices are available"):
            tlaunch.rank_devices(n)
    else:   # no card: the default device raises, never the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlaunch.rank_devices(2)
    mesh = tmesh.make_task_mesh(devices=("cpu",) * 3, axis="seeds")
    assert (mesh.size, mesh.axis, mesh.rank) == (3, "seeds", None)


def test_shard_task_batch_rejects_non_divisible(eight_devices):
    with pytest.raises(ValueError, match="not divisible") as ours:
        tmesh.shard_task_batch(tmesh.make_task_mesh(devices=("cpu",) * 8),
                               torch.zeros(6, 3))
    with pytest.raises(ValueError, match="not divisible") as theirs:
        jparallel.shard_task_batch(jparallel.make_task_mesh(8),
                                   jnp.zeros((6, 3)))
    assert str(ours.value) == str(theirs.value)
    shards = tmesh.shard_task_batch(tmesh.make_task_mesh(
        devices=("cpu",) * 2), (torch.arange(4),
                                {"x": torch.arange(8).view(4, 2)}))
    assert [s[0].tolist() for s in shards] == [[0, 1], [2, 3]]
    assert [s[1]["x"].tolist() for s in shards] == [[[0, 1], [2, 3]],
                                                    [[4, 5], [6, 7]]]


def test_a_failing_rank_fails_the_launch_in_seconds():
    """The launch raises the first failure it sees: rank 1's error, or
    rank 0's collective failing once rank 1 has gone."""
    start = time.perf_counter()
    with pytest.raises(mp.ProcessRaisedException,
                       match="rank 1 fails on purpose|all_reduce|Connection"):
        tlaunch.launch(W.fail_on_rank_one, 2, device="cpu")
    # the collective rank 0 waits in would time out after TIMEOUT_S
    assert time.perf_counter() - start < min(60, tlaunch.TIMEOUT_S)


def test_ranks_know_themselves_and_refuse_what_they_cannot_run():
    outs = tlaunch.launch(W.whoami, 2, device="cpu")
    got = [o["result"] for o in outs]
    assert [g["rank"] for g in got] == [0, 1]
    assert all(g["size"] == 2 and g["backend"] == "gloo"
               and g["device"] == "cpu" and g["threads"] == 1
               and g["pmean"] == [0.5, 1.0] for g in got)
    assert outs[0]["counts"]["collectives"]["all_reduce"] == 1
    with pytest.raises(ValueError, match="CPU takes gloo"):
        tlaunch.launch(W.whoami, 2, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="one rank a card"):
        tlaunch._backend((torch.device("cuda", 0),) * 2, None)
    with pytest.raises(ValueError, match="gloo collectives cannot be "
                       "captured"):
        tmesh.check_fusable(tmesh.TaskMesh(["cuda:0"] * 2, rank=0,
                                           backend="gloo"), "cuda:0")
    tmesh.check_fusable(tmesh.TaskMesh(["cpu"] * 2, rank=0,
                                       backend="gloo"), "cpu")
    with pytest.raises(RuntimeError, match="no collectives"):
        tmesh.make_task_mesh(devices=("cpu",)).pmean(torch.ones(1))


# -- the servers -----------------------------------------------------------

@pytest.mark.parametrize("n_dev,n_req", [(2, 4), (8, 8), (8, 5)])
def test_vision_server_mesh_equals_the_unsharded_batch(n_dev, n_req):
    spec = tcnn.omniglot_spec(5, hidden=8, layers=2)
    params = tcnn.init_cnn4(torch.Generator().manual_seed(0), spec,
                            device="cpu")
    rng = np.random.default_rng(0)
    sx = rng.uniform(size=(n_req, 5, 28, 28, 1)).astype(np.float32)
    sy = np.tile(np.arange(5), (n_req, 1))
    qx = rng.uniform(size=(n_req, 7, 28, 28, 1)).astype(np.float32)
    kw = dict(inner_lr=0.4, adapt_steps=1)
    want = VisionServer(spec, params, device="cpu", **kw).batch(sx, sy, qx)
    mesh = tmesh.make_task_mesh(devices=("cpu",) * n_dev)
    got = VisionServer(spec, params, mesh=mesh, **kw).batch(sx, sy, qx)
    assert got[1].shape == want[1].shape == (n_req, 7, 5)
    assert torch.equal(got[0], want[0])
    assert float((got[1] - want[1]).abs().max()) <= 1e-6 * float(
        want[1].abs().max())


@pytest.mark.parametrize("n_dev,n_req", [(2, 4), (8, 8), (8, 5)])
def test_policy_server_mesh_equals_the_unsharded_batch(n_dev, n_req):
    policy = DiagNormalPolicy(2, 2, hiddens=W.HIDDENS)
    params = policy.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    T, E = 5, 3
    support = W.traj((
        rng.uniform(-1, 1, (n_req, T, E, 2)).astype(np.float32),
        rng.normal(0, 0.3, (n_req, T, E, 2)).astype(np.float32),
        rng.normal(size=(n_req, T, E)).astype(np.float32),
        np.zeros((n_req, T, E), np.float32),
        rng.uniform(-1, 1, (n_req, T, E, 2)).astype(np.float32),
        np.zeros((n_req, T, E), np.float32),
        np.ones((n_req, T, E), np.float32),
        np.broadcast_to(np.arange(T)[None, :, None], (n_req, T, E)).copy()))
    cfg = RLConfig(inner_lr=0.1, adapt_steps=1, adapt_batch_size=E,
                   max_path_length=T)
    plain = PolicyServer(policy, params, cfg, algo="ppo", device="cpu")
    sharded = PolicyServer(policy, params, cfg, algo="ppo",
                           mesh=tmesh.make_task_mesh(devices=("cpu",) * n_dev))
    want, got = plain.adapt_batched(support), sharded.adapt_batched(support)
    top = max(float(v.abs().max()) for v in tree_leaves(want))
    for (k, a), (_, b) in zip(tree_items(got), tree_items(want)):
        assert a.shape == b.shape and float((a - b).abs().max()) <= 1e-6 * top
    obs = torch.as_tensor(rng.uniform(-1, 1, (n_req, E, 2)),
                          dtype=torch.float32)
    a, b = sharded.act_batched(got, obs), plain.act_batched(want, obs)
    assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    a = sharded.sample_batched(got, torch.Generator().manual_seed(2), obs)
    b = plain.sample_batched(want, torch.Generator().manual_seed(2), obs)
    assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
