"""Fused meta-iterations (``--fuse N``) of the PyTorch port, on the CPU: the
chunk driver against the JAX package's, the fused loop's bookkeeping, the
vision trainer fused against per-iteration, and the sampler's labels.

On the CPU a fused chunk runs its iterations eagerly, on the kernels'
plain twins, so ``--fuse 3`` must give the per-iteration run's
``metrics.json`` rows and ``model.npz`` bit for bit; only the checkpoints
move, to the chunk-end iterations that JAX's driver picks. The CUDA-graph
path is held against the eager one on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_meta_tpu.trainers.fused import (
    drive_fused_chunks as jax_drive,
)
from exploring_meta_tpu_torch import cli
from exploring_meta_tpu_torch.adapt import maml as tm
from exploring_meta_tpu_torch.models.layers import get_conv_impl, set_conv_impl
from exploring_meta_tpu_torch.tasks import datasets as td
from exploring_meta_tpu_torch.tasks import sampler as ts
from exploring_meta_tpu_torch.trainers import fused as tf
from exploring_meta_tpu_torch.trainers import vision as tv
from exploring_meta_tpu_torch.utils import graphs
from exploring_meta_tpu_torch.utils.config import VisionConfig

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these small runs only lose to the contention of
    several test workers' thread pools on the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CASES = [(5, 2, 2, 0), (7, 3, 4, 2), (4, 10, 1, 0)]  # total, fuse, save, start


class _Bar:
    def __init__(self, log):
        self.log = log

    def update(self, n):
        self.log.append(("update", n))

    def set_postfix(self, d):
        self.log.append(("postfix", d))


def _drive(side, total, fuse, save_every, start, stop_at=None):
    """One package's driver on a stub chunk (the state counts iterations;
    iteration i reports loss i) -> (record of every callback, result or
    the interrupt)."""
    log, calls = [], []

    def run_chunk(n, state, k):
        calls.append(n)
        if len(calls) == stop_at:
            raise KeyboardInterrupt
        loss = np.arange(state, state + n, dtype=np.float32)
        ms = ({"loss": jnp.asarray(loss)} if side == "jax"
              else {"loss": torch.from_numpy(loss)})
        return state + n, ms

    kw = dict(total=total, fuse=fuse, save_every=save_every, state=start,
              run_chunk=run_chunk, start=start,
              log_step=lambda ms, j: log.append(("log", j,
                                                 float(ms["loss"][j]))),
              postfix=lambda ms: {"last": float(ms["loss"][-1])},
              save_ckpt=lambda s, i, k: log.append(("ckpt", s, i)),
              progress=_Bar(log),
              on_chunk=lambda s, i: log.append(("chunk", s, i)))
    try:
        if side == "jax":
            import jax
            state, it, _ = jax_drive(key=jax.random.key(0), **kw)
        else:
            state, it, _ = tf.drive_fused_chunks(
                gen=torch.Generator().manual_seed(0), **kw)
        return log, (state, it)
    except KeyboardInterrupt:
        return log, "interrupted"


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("stop_at", [None, 2])
def test_drive_fused_chunks_matches_jax(case, stop_at):
    ours = _drive("torch", *case, stop_at=stop_at)
    theirs = _drive("jax", *case, stop_at=stop_at)
    assert ours == theirs
    assert ours[0], "the driver ran"


def test_fetch_is_one_copy_of_every_metric():
    ms = {"a": torch.arange(3.0), "ok": torch.tensor([True, False, True])}
    host = tf.fetch(ms)
    assert list(host) == ["a", "ok"]
    np.testing.assert_array_equal(host["ok"], [1.0, 0.0, 1.0])
    assert host["a"].dtype == np.float32
    out = tf.host_metrics({"x": torch.tensor(0.25), "b": True, "n": 2.0})
    assert out == {"x": 0.25, "b": True, "n": 2.0}


def test_fused_iterations_chunks_and_binding():
    state = torch.zeros(())

    def iteration():
        state.add_(1.0)
        return {"s": state * 1.0, "twice": state * 2.0}

    loop = graphs.FusedIterations(iteration, 4, "cpu")
    first = loop(3)
    assert {k: v.tolist() for k, v in first.items()} == {
        "s": [1.0, 2.0, 3.0], "twice": [2.0, 4.0, 6.0]}
    assert loop(2)["s"].tolist() == [4.0, 5.0]
    assert first["s"].tolist() == [1.0, 2.0, 3.0]   # rows are copies
    assert loop()["s"].tolist() == [6.0, 7.0, 8.0, 9.0]
    for bad in (0, 5):
        with pytest.raises(ValueError, match="chunk"):
            loop(bad)
    assert graphs.COUNTS == {"captures": 0, "replays": 0}  # none on the CPU

    get = graphs.bind_once(lambda a, b: object())
    a, b = object(), object()
    assert get(a, b) is get(a, b)
    with pytest.raises(ValueError, match="bound"):
        get(b, a)


def test_train_scan_runs_any_chunk_length_on_one_loop():
    """``make_train_scan(n_steps)`` serves shorter chunks too, and a chunk
    of 2 then 1 equals a chunk of 3 (the eager path, bit for bit)."""
    data = td.load_omniglot(seed=3, synthetic=True, synthetic_classes=30,
                            synthetic_per_class=4, device="cpu")[0]
    from exploring_meta_tpu_torch.adapt.vision import make_vision_fast_adapt
    from exploring_meta_tpu_torch.models import cnn4
    spec = cnn4.omniglot_spec(5, hidden=4)
    fa = make_vision_fast_adapt(spec, 0.1, 1, 1, 5)
    sample = lambda g: ts.sample_task_batch(g, data, 5, 1, 2)
    prev = get_conv_impl()
    set_conv_impl("direct")
    try:
        runs = []
        for chunks in ((2, 1), (3,)):
            gen = torch.Generator().manual_seed(4)
            params = cnn4.init_cnn4(torch.Generator().manual_seed(5), spec,
                                     device="cpu")
            params = tm.tree_map(lambda t: t.requires_grad_(), params)
            opt = tm.adam(params, 1e-2)
            train = tm.make_train_scan(fa, sample, 3, eval_sample_fn=sample)
            rows = [train(params, opt, gen, n)[2] for n in chunks]
            runs.append((params, {k: torch.cat([r[k] for r in rows])
                                  for k in rows[0]}))
            with pytest.raises(ValueError, match="bound"):
                train(dict(params), opt, gen)
    finally:
        set_conv_impl(prev)
    (p1, m1), (p2, m2) = runs
    assert list(m1) == ["loss", "metric", "valid_loss", "valid_metric"]
    for k in m1:
        torch.testing.assert_close(m1[k], m2[k], rtol=0, atol=0)
    for a, b in zip(tm.tree_leaves(p1), tm.tree_leaves(p2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _vision_run(tmp_path, fuse, anil, total=5, save_every=2):
    prev = get_conv_impl()
    cfg = VisionConfig(fuse=fuse, num_iterations=total, save_every=save_every,
                       meta_batch_size=2, shots=1, synthetic=True,
                       conv_impl="fused")
    try:
        trainer = tv.VisionTrainer(cfg, anil=anil,
                                   path=str(tmp_path / f"f{fuse}") + "/",
                                   device="cpu")
        acc = trainer.run()
    finally:
        set_conv_impl(prev)
    run = trainer.model_path
    with open(os.path.join(run, "metrics.json")) as f:
        metrics = json.load(f)
    with np.load(os.path.join(run, "model.npz")) as z:
        model = {k: z[k] for k in z.files}
    ckpts = sorted(os.listdir(os.path.join(run, "model_checkpoints")))
    return acc, metrics, model, ckpts


def _jax_checkpoints(total, fuse, save_every):
    """The iterations at which JAX's fused driver checkpoints."""
    import jax
    its = []
    jax_drive(total=total, fuse=fuse, save_every=save_every,
              key=jax.random.key(0), state=0,
              run_chunk=lambda n, s, k: (s, {"x": jnp.zeros(n)}),
              log_step=lambda ms, j: None, postfix=lambda ms: {},
              save_ckpt=lambda s, i, k: its.append(i), progress=_Bar([]))
    return [f"model_{i}.npz" for i in its]


@pytest.mark.parametrize("anil", [False, True], ids=["maml", "anil"])
def test_vision_fuse_3_matches_fuse_1_bit_for_bit(tmp_path, anil):
    acc1, m1, z1, c1 = _vision_run(tmp_path, 1, anil)
    acc3, m3, z3, c3 = _vision_run(tmp_path, 3, anil)
    assert m3 == m1 and acc3 == acc1
    assert len(m1["train_loss"]) == 5
    assert z1.keys() == z3.keys()
    for k in z1:
        np.testing.assert_array_equal(z3[k], z1[k])
    assert c1 == ["model_0.npz", "model_2.npz", "model_4.npz"]
    assert c3 == _jax_checkpoints(5, 3, 2) == ["model_2.npz", "model_4.npz"]


def test_vision_fused_interrupt_keeps_whole_chunks(tmp_path, monkeypatch):
    """An interrupt in the second chunk: metrics.json keeps the first
    chunk's rows, model.npz its params (= the chunk-end checkpoint), and
    the recorded iteration count is the chunk's."""
    real = tm.make_train_scan

    def interrupting(*args, **kw):
        train, calls = real(*args, **kw), []

        def wrapped(params, opt, gen, n=None):
            calls.append(n)
            if len(calls) == 2:
                train(params, opt, gen, 1)   # moves the params, then stops
                raise KeyboardInterrupt
            return train(params, opt, gen, n)
        return wrapped

    monkeypatch.setattr(tv, "make_train_scan", interrupting)
    acc, metrics, model, ckpts = _vision_run(tmp_path, 2, False, total=6)
    (run,) = os.listdir(tmp_path / "f2")
    with open(tmp_path / "f2" / run / "logger.json") as f:
        logger = json.load(f)
    assert logger["manually_stopped"] is True
    assert logger["config"]["num_iterations"] == 2
    assert len(metrics["train_loss"]) == 2 and np.isfinite(acc)
    assert ckpts == ["model_1.npz"]
    with np.load(tmp_path / "f2" / run / "model_checkpoints" /
                 "model_1.npz") as z:
        for k in model:
            np.testing.assert_array_equal(model[k], z[k])


def test_vision_cli_takes_fuse(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("EMT_FORCE_CPU", "1")
    prev = get_conv_impl()
    try:
        acc = cli.anil_vision(["--num_iterations", "3", "--meta_batch_size",
                               "2", "--shots", "1", "--synthetic", "--fuse",
                               "2"])
    finally:
        set_conv_impl(prev)
    (run,) = os.listdir(tmp_path / "results")
    with open(tmp_path / "results" / run / "logger.json") as f:
        logger = json.load(f)
    assert logger["config"]["fuse"] == 2 and np.isfinite(acc)
    with open(tmp_path / "results" / run / "metrics.json") as f:
        assert len(json.load(f)["valid_acc"]) == 3


@pytest.mark.parametrize("command", ["maml_trpo", "anil_trpo", "maml_ppo",
                                     "anil_ppo", "maml_vpg", "anil_vpg"])
def test_rl_cli_entries_take_fuse(tmp_path, monkeypatch, command):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("EMT_FORCE_CPU", "1")
    final = cli.COMMANDS[command](
        ["--num_iterations", "3", "--meta_batch_size", "2",
         "--adapt_batch_size", "2", "--max_path_length", "6",
         "--n_eval_tasks", "2", "--fc_neurons", "8", "--outer_lr", "0.01",
         "--save_every", "2", "--fuse", "2"])
    assert np.isfinite(final["mean_reward"])
    (run,) = os.listdir(tmp_path / "results")
    with open(tmp_path / "results" / run / "logger.json") as f:
        assert json.load(f)["config"]["fuse"] == 2
    with open(tmp_path / "results" / run / "metrics.json") as f:
        assert len(json.load(f)["meta_loss"]) == 3
    assert os.listdir(tmp_path / "results" / run / "model_checkpoints") == [
        "model_1.npz"]


@pytest.mark.parametrize("ways,shots", [(5, 1), (5, 5), (20, 1), (3, 2)])
def test_sampler_labels_unchanged_bit_for_bit(ways, shots):
    data = td.load_omniglot(seed=1, synthetic=True, synthetic_classes=40,
                            synthetic_per_class=10, device="cpu")[0]
    _, labels = ts.sample_task_batch(torch.Generator().manual_seed(0), data,
                                     ways, shots, 3)
    want = torch.arange(ways).repeat_interleave(2 * shots)
    assert labels.dtype == want.dtype == torch.int64
    assert torch.equal(labels, want.expand(3, -1))
