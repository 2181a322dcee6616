"""The port's serving load tests (``serve_load.py``,
``cli.py:serve_vision|serve_rl``) against ``scripts/serve_vision.py`` and
``scripts/serve_rl.py``, on the CPU.

Both run under ``EMT_FORCE_CPU=1`` at 2 requests and 1 timed repetition;
their result lines must read as the JAX scripts' do, numbers aside, and
the line before them must give each kernel's launches over one batch
(zero on the CPU, where the plain twins run). A ``model.npz`` written by
the JAX package serves in both. Without a card and without
``EMT_FORCE_CPU`` they raise; a ``--mesh`` larger than the cards present
raises JAX's ``ValueError``.
"""

import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from exploring_meta_tpu import models as jmodels
from exploring_meta_tpu.utils.experiment import flatten_params as jflatten
from exploring_meta_tpu_torch import cli
from exploring_meta_tpu_torch.cuda import cnn4_cuda, gae_cuda

SCRIPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       os.pardir, "scripts")
sys.path.insert(0, SCRIPTS)
import serve_rl as jserve_rl  # noqa: E402
import serve_vision as jserve_vision  # noqa: E402

VISION = ["--batch", "2", "--reps", "1"]
RL = ["--tasks", "2", "--reps", "1", "--act_steps", "2", "--episodes", "2",
      "--horizon", "8"]
NUMBER = re.compile(r"\d+(\.\d+)?")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lines(capsys) -> list:
    return capsys.readouterr().out.strip().splitlines()


def _masked(line: str) -> str:
    return NUMBER.sub("N", line)


def _jax_lines(main, argv, capsys, monkeypatch) -> list:
    monkeypatch.setattr(sys, "argv", ["script.py"] + argv)
    capsys.readouterr()
    main()
    return _lines(capsys)


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("EMT_FORCE_CPU", "1")


def test_serve_vision_prints_the_scripts_result_line(cpu, capsys,
                                                     monkeypatch):
    argv = VISION + ["--random_init"]
    want = _jax_lines(jserve_vision.main, argv, capsys, monkeypatch)
    res = cli.serve_vision(argv)
    got = _lines(capsys)
    assert [_masked(x) for x in got[-1:]] == [_masked(x) for x in want[-1:]]
    assert got[-1].startswith("batch=2 omni 5w5s maml bf16: ")
    assert got[-2] == ("kernel launches in one batch: cnn4_block_fwd 0, "
                       "cnn4_block_bwd_params 0, cnn4_block_bwd_input 0, "
                       "cnn4_block_double_backward 0")
    assert res["launches"] == {k: 0 for k in cnn4_cuda.KERNELS}
    assert res["requests_per_s"] > 0 and res["device"] == "cpu"


@pytest.mark.parametrize("flags", [["--f32"], ["--anil", "--shots", "1"],
                                   ["--dataset", "min", "--queries", "2"]],
                         ids=["f32", "anil", "min"])
def test_serve_vision_variants(flags, cpu, capsys):
    cli.serve_vision(VISION + ["--random_init"] + flags)
    line = _lines(capsys)[-1]
    assert re.fullmatch(
        r"batch=2 (omni|min) 5w[15]s (maml|anil) (f32|bf16): \d+ "
        r"requests/sec, batch latency [\d.]+ ms \([\d.]+ ms/request\)",
        line), line
    assert ("f32" in line) == ("--f32" in flags)


def test_serve_rl_prints_the_scripts_result_lines(cpu, capsys, monkeypatch):
    argv = RL + ["--random_init", "--algo", "trpo"]
    want = _jax_lines(jserve_rl.main, argv, capsys, monkeypatch)
    res = cli.serve_rl(argv)
    got = _lines(capsys)
    assert ([_masked(x) for x in got[-2:]]
            == [_masked(x) for x in want[-2:]])
    assert got[-2].startswith("adapt[trpo] 2 tasks x 1 step(s): ")
    assert got[-3] == ("kernel launches in one batch: gae_sweep 0, "
                       "discount_sweep 0")
    assert res["launches"] == {k: 0 for k in gae_cuda.KERNELS}
    assert res["tasks_per_s"] > 0 and res["act_s"] > 0


@pytest.mark.parametrize("flags", [["--algo", "ppo"], ["--anil"],
                                   ["--activation", "tanh",
                                    "--adapt_steps", "2"]],
                         ids=["ppo", "anil", "tanh-2-steps"])
def test_serve_rl_variants(flags, cpu, capsys):
    cli.serve_rl(RL + ["--random_init"] + flags)
    adapt, act = _lines(capsys)[-2:]
    assert re.fullmatch(r"adapt\[(vpg|ppo)(/anil)?\] 2 tasks x [12] "
                        r"step\(s\): \d+ tasks/sec \([\d.]+ ms/batch\)",
                        adapt), adapt
    assert re.fullmatch(r"act: \d+ us/step for 2 parallel envs \(\d+ "
                        r"steps/sec\)", act), act


def _save(tree, path):
    np.savez(path, **{k: np.asarray(v) for k, v in jflatten(tree).items()})


def test_jax_written_checkpoints_serve(cpu, capsys, tmp_path):
    """``model.npz`` files of JAX params serve in the port's load tests;
    the loaded params are JAX's."""
    from exploring_meta_tpu_torch.models import cnn4
    from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
    from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig
    from exploring_meta_tpu_torch.serve import PolicyServer, VisionServer
    from exploring_meta_tpu_torch.utils.tree import tree_items

    jvision = jmodels.init_cnn4(jax.random.key(5), jmodels.omniglot_spec(5))
    jpolicy = jmodels.DiagNormalPolicy(2, 2).init(jax.random.key(6))
    _save(jvision, tmp_path / "vision.npz")
    _save(jpolicy, tmp_path / "policy.npz")
    cli.serve_vision(VISION + [str(tmp_path / "vision.npz")])
    cli.serve_rl(RL + [str(tmp_path / "policy.npz")])
    lines = _lines(capsys)
    assert any("requests/sec" in x for x in lines)
    assert any("tasks/sec" in x for x in lines)
    served = [
        VisionServer.from_checkpoint(str(tmp_path / "vision.npz"),
                                     cnn4.omniglot_spec(5), inner_lr=0.5,
                                     adapt_steps=1, device="cpu").params,
        PolicyServer.from_checkpoint(str(tmp_path / "policy.npz"),
                                     DiagNormalPolicy(2, 2), RLConfig(),
                                     device="cpu").params]
    for got, want in zip(served, (jvision, jpolicy)):
        want = jflatten(want)
        got = dict(tree_items(got))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_a_checkpoint_or_random_init_is_required(cpu):
    for run in (cli.serve_vision, cli.serve_rl):
        with pytest.raises(SystemExit):
            run(["--batch", "2"] if run is cli.serve_vision else [])


def test_without_a_card_they_raise(monkeypatch):
    monkeypatch.delenv("EMT_FORCE_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.serve_vision(VISION + ["--random_init"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.serve_rl(RL + ["--random_init"])


def test_a_mesh_larger_than_the_cards_raises(cpu, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="requested a 2-device mesh but "
                                         "only 0 devices are available"):
        cli.serve_rl(RL + ["--random_init", "--mesh", "2"])
