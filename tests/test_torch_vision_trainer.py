"""MAML/ANIL vision trainer, config and CLI of the PyTorch port, on the CPU.

``maml_vision`` and ``anil_vision`` run from argv with ``EMT_FORCE_CPU=1``
for 2 iterations on the small synthetic Omniglot (160 classes x 20), at
meta-batch 2, 5-way 1-shot. The run directory must keep the JAX
package's contract: the same files and JSON keys, and ``.npz`` key names
that the JAX package's ``load_params`` / ``load_checkpoint`` read into a
JAX template (the ``eval_vision`` contract).
"""

import dataclasses
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from exploring_meta_tpu.models import cnn4 as jc
from exploring_meta_tpu.utils import config as jconfig
from exploring_meta_tpu.utils.experiment import load_checkpoint as jload_ckpt
from exploring_meta_tpu.utils.experiment import load_params as jload_params
from exploring_meta_tpu_torch import cli
from exploring_meta_tpu_torch.models import cnn4 as tcnn
from exploring_meta_tpu_torch.models.layers import get_conv_impl, set_conv_impl
from exploring_meta_tpu_torch.trainers import vision as tv
from exploring_meta_tpu_torch.utils.config import (
    VisionConfig, anil_vision_defaults, vision_argparser,
)
from exploring_meta_tpu_torch.utils.experiment import load_params

ARGV = ["--num_iterations", "2", "--meta_batch_size", "2", "--shots", "1",
        "--save_every", "1", "--synthetic"]
METRICS = {"train_loss", "train_acc", "valid_loss", "valid_acc", "test_acc"}
SPECS = {"maml": (jc.omniglot_spec(5), tcnn.omniglot_spec(5)),
         "anil": (jc.anil_omniglot_spec(5), tcnn.anil_omniglot_spec(5))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs from argv on the CPU -> {algo: (test_acc, run dir, conv
    impl the run set)}; MAML asks for the JAX name ``pallas``."""
    tmp = tmp_path_factory.mktemp("runs")
    prev = get_conv_impl()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        mp.setenv("EMT_FORCE_CPU", "1")
        set_conv_impl("direct")
        for algo, main, extra in (("maml", cli.maml_vision,
                                   ["--conv_impl", "pallas"]),
                                  ("anil", cli.anil_vision, [])):
            acc = main(ARGV + extra)
            (run,) = [d for d in os.listdir(tmp / "results")
                      if d.startswith(algo)]
            out[algo] = (acc, str(tmp / "results" / run), get_conv_impl())
    set_conv_impl(prev)
    return out


@pytest.mark.parametrize("algo", ["maml", "anil"])
def test_run_dir_contract(runs, algo):
    acc, run, _ = runs[algo]
    assert os.path.basename(run).startswith(f"{algo}_5w1s_omni_")
    assert sorted(os.listdir(run)) == [
        "logger.json", "metrics.json", "model.npz", "model.summary",
        "model_checkpoints"]
    assert sorted(os.listdir(os.path.join(run, "model_checkpoints"))) == [
        "model_0.npz", "model_1.npz"]
    with open(os.path.join(run, "metrics.json")) as f:
        metrics = json.load(f)
    assert set(metrics) == METRICS
    assert all(len(metrics[k]) == 2 for k in METRICS - {"test_acc"})
    assert all(math.isfinite(v) for vals in metrics.values() for v in vals)
    with open(os.path.join(run, "logger.json")) as f:
        logger = json.load(f)
    assert {"config", "date", "model_id", "elapsed_time",
            "test_acc"} <= set(logger)
    assert logger["config"]["algo"] == f"{algo}_5w1s"
    assert logger["test_acc"] == acc == metrics["test_acc"][0]
    assert 0.0 <= acc <= 1.0
    assert logger["config"]["outer_lr"] == (0.003 if algo == "maml" else 0.001)


def test_conv_impl_pallas_runs_the_fused_path(runs):
    assert runs["maml"][2] == "fused"
    with open(os.path.join(runs["maml"][1], "logger.json")) as f:
        assert json.load(f)["config"]["conv_impl"] == "fused"


@pytest.mark.parametrize("algo", ["maml", "anil"])
def test_jax_package_reads_the_ports_model_and_checkpoints(runs, algo):
    import jax
    _, run, _ = runs[algo]
    jspec, tspec = SPECS[algo]
    jtemplate = jc.init_cnn4(jax.random.key(0), jspec)
    jparams = jload_params(os.path.join(run, "model.npz"), jtemplate)
    params = load_params(os.path.join(run, "model.npz"), tcnn.init_cnn4(
        torch.Generator().manual_seed(0), tspec, device="cpu"))
    for j, t in zip(jax.tree_util.tree_leaves(jparams),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    _, opt, rng, iteration = jload_ckpt(
        os.path.join(run, "model_checkpoints", "model_1.npz"), jtemplate)
    assert (opt, rng, iteration) == (None, None, 1)


def test_default_device_is_the_card_never_the_cpu(tmp_path, monkeypatch):
    cfg = VisionConfig(num_iterations=1)
    if torch.cuda.is_available():
        assert tv.VisionTrainer(cfg, path=str(tmp_path) + "/").device.type \
            == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tv.VisionTrainer(cfg, path=str(tmp_path) + "/")
    assert os.listdir(tmp_path) == []
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("EMT_FORCE_CPU", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.maml_vision(ARGV)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("change,item", [
    ({"mesh": 2, "meta_batch_size": 3}, "not divisible by mesh size 2"),
])
def test_options_not_ported_raise(tmp_path, change, item):
    """``--mesh`` is ported (``tests/test_torch_mesh.py``); a meta-batch
    that the ranks cannot share raises before any rank is started, with
    JAX's message."""
    trainer = tv.VisionTrainer(VisionConfig(**change),
                               path=str(tmp_path) + "/", device="cpu")
    with pytest.raises(ValueError, match=item):
        trainer.run()
    assert os.listdir(trainer.model_path) == ["model_checkpoints"]


@pytest.mark.parametrize("change", [
    {"resume": "model_checkpoints/model_0.npz"}, {"async_ckpt": True},
    {"ckpt_backend": "orbax"}, {"use_wandb": True}, {"profile": True},
    {"trace": "trace_dir"}, {"compile_cache": "cache"},
], ids=lambda c: next(iter(c)))
def test_run_utilities_run(tmp_path, monkeypatch, capsys, runs, change):
    """Each run utility constructs the trainer and runs a tiny MAML run
    (``ARGV``'s config): the resume continues the ``runs`` MAML run at
    iteration 1 and logs its row 1 and meta-test exactly; an async
    checkpoint and a DCP step land; without wandb the run says so and goes
    on; ``--profile`` writes JAX's phases; ``--trace`` a Chrome trace;
    ``--compile_cache`` moves the kernels' build directory."""
    from exploring_meta_tpu_torch.cuda import build
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.setitem(sys.modules, "wandb", None)
    prev = get_conv_impl()
    change = dict(change)
    if "resume" in change:
        change["resume"] = os.path.join(runs["maml"][1], change["resume"])
    args = vars(vision_argparser(VisionConfig(), "").parse_args(
        ARGV + ["--conv_impl", "pallas"]))
    args["num_iterations"] = 1 + ("resume" in change)
    trainer = tv.VisionTrainer(VisionConfig(**{**args, **change}),
                               path=str(tmp_path / "runs") + "/",
                               device="cpu")
    trainer.run()
    set_conv_impl(prev)
    out = capsys.readouterr().out
    run = trainer.model_path
    with open(os.path.join(run, "metrics.json")) as f:
        metrics = json.load(f)
    assert len(metrics["train_loss"]) == 1
    if "resume" in change:
        with open(os.path.join(runs["maml"][1], "metrics.json")) as f:
            full = json.load(f)
        assert all(metrics[k] == full[k][-1:] for k in METRICS)
    elif "async_ckpt" in change:
        with np.load(os.path.join(run, "model_checkpoints",
                                  "model_0.npz")) as z:
            assert int(z["__iteration__"]) == 0
            assert int(z["__opt__/0/count"]) == 1
    elif "ckpt_backend" in change:
        assert os.listdir(os.path.join(run, "model_checkpoints")) == ["0"]
    elif "use_wandb" in change:
        assert "wandb unavailable" in out
    elif "profile" in change:
        with open(os.path.join(run, "phase_times.json")) as f:
            phases = json.load(f)
        assert set(phases) == {"sample", "valid_eval", "meta_step"}
    elif "trace" in change:
        (trace,) = os.listdir(tmp_path / "trace_dir")
        with open(tmp_path / "trace_dir" / trace) as f:
            assert "traceEvents" in json.load(f)
    else:
        assert build.BUILD_DIR == str(tmp_path / "cache")


def test_config_and_flags_match_the_jax_package():
    for ours, theirs in ((VisionConfig(), jconfig.VisionConfig()),
                         (anil_vision_defaults(),
                          jconfig.anil_vision_defaults())):
        ours, theirs = dataclasses.asdict(ours), dataclasses.asdict(theirs)
        assert (ours.pop("conv_impl"), theirs.pop("conv_impl")) == (
            "fused", "direct")
        assert ours == theirs
    argv = ["--num_iterations", "7", "--wandb", "--no_nan_guard", "--bf16",
            "--dataset", "min", "--synth_per_class", "3", "--remat_body",
            "--conv_impl", "pallas"]
    for a in ([], argv):
        ours = vars(vision_argparser(VisionConfig(), "p").parse_args(a))
        theirs = vars(jconfig.vision_argparser(jconfig.VisionConfig(),
                                               "j").parse_args(a))
        assert (ours.pop("conv_impl"), theirs.pop("conv_impl")) == (
            ("fused", "pallas") if a else ("fused", "direct"))
        assert ours == theirs
    for name in ("direct", "s2d", "fused"):
        assert vision_argparser(VisionConfig(), "p").parse_args(
            ["--conv_impl", name]).conv_impl == name
    with pytest.raises(SystemExit):
        vision_argparser(VisionConfig(), "p").parse_args(
            ["--conv_impl", "winograd"])


def _scripted_step(losses):
    """A meta-step that reports scripted losses, or is interrupted."""
    it = iter(losses)

    def make(fast_adapt):
        def step(params, opt, *batch):
            loss = next(it)
            if loss is KeyboardInterrupt:
                raise KeyboardInterrupt
            one = torch.tensor(loss)
            return params, opt, {"loss": one, "metric": one * 0}
        return step
    return make


@pytest.mark.parametrize("stop", ["diverged", "interrupted"])
def test_graceful_finish(tmp_path, monkeypatch, stop):
    monkeypatch.setattr(tv, "make_meta_step", _scripted_step(
        [0.5, float("nan") if stop == "diverged" else KeyboardInterrupt,
         0.1]))
    prev = get_conv_impl()
    cfg = VisionConfig(num_iterations=3, meta_batch_size=2, synthetic=True,
                       conv_impl="direct")
    try:
        trainer = tv.VisionTrainer(cfg, path=str(tmp_path) + "/",
                                   device="cpu")
        acc = trainer.run()
    finally:
        set_conv_impl(prev)
    run = trainer.model_path
    with open(os.path.join(run, "logger.json")) as f:
        logger = json.load(f)
    with open(os.path.join(run, "metrics.json")) as f:
        metrics = json.load(f)
    assert logger["config"]["num_iterations"] == 1
    assert math.isfinite(acc) and logger["test_acc"] == acc
    assert os.path.exists(os.path.join(run, "model.npz"))
    if stop == "diverged":
        assert "train_loss = nan at logged step 1" in logger["diverged"]
        assert metrics["train_loss"] == [0.5, None]     # strict JSON
    else:
        assert logger["manually_stopped"] is True
        assert metrics["train_loss"] == [0.5]
