"""The port's accuracy-parity harness (``parity/``, ``cli.py:parity_check``)
against ``scripts/parity_check.py`` and ``scripts/torch_rl_repro.py``, on
the CPU.

The port keeps its own copies of the two torch reproductions of the
reference; they must train exactly as the originals do: the same trained
weights and the same meta-test accuracy or rewards, bit for bit, with one
intra-op thread. The harness itself must keep the JAX script's flags,
defaults, RL hyperparameters, result keys (``jax_`` renamed ``port_``)
and arithmetic, evaluate exactly ``eval_tasks`` tasks, and pair the RL
pre- and post-training meta-tests on one generator state.
"""

import argparse
import json
import os
import sys

import numpy as np
import pytest
import torch

from exploring_meta_tpu_torch import cli
from exploring_meta_tpu_torch.parity import check
from exploring_meta_tpu_torch.parity import reference_rl
from exploring_meta_tpu_torch.parity import reference_vision

SCRIPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       os.pardir, "scripts")
sys.path.insert(0, SCRIPTS)
import parity_check as jpc  # noqa: E402
import torch_rl_repro as jrepro  # noqa: E402

# a tiny RL configuration: both loops, the paired evaluations and the
# TRPO line search all run
TINY_RL = {"num_iterations": 2, "meta_batch_size": 2, "n_eval_tasks": 2,
           "adapt_batch_size": 2, "max_path_length": 8}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: bit-for-bit equality of two runs of the same
    float32 code needs one summation order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def images():
    """The parity run's synthetic datasets as the uint8 arrays that the
    reproductions take."""
    out = {}
    for ds in ("omni", "min"):
        train, test = check.load_vision_data(ds, "cpu")
        out[ds] = (train.images.numpy(), test.images.numpy())
    return out


def _adams(monkeypatch):
    """Record every ``torch.optim.Adam`` that the runs create (each run's
    optimizer holds its model's trained parameters)."""
    made = []

    class Recording(torch.optim.Adam):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(torch.optim, "Adam", Recording)
    return made


@pytest.mark.parametrize("dataset", ["omni", "min"])
@pytest.mark.parametrize("anil", [False, True])
def test_reference_vision_equals_the_script_bit_for_bit(images, dataset,
                                                        anil, monkeypatch):
    train, test = images[dataset]
    made = _adams(monkeypatch)
    lr = 0.5 if dataset == "omni" else 0.1
    args = (train, test, 2, 2, lr, 0.003, 1, 4, 42)
    want = jpc.run_torch(*args, dataset=dataset, anil=anil)
    got = reference_vision.run_torch(*args, dataset=dataset, anil=anil)
    assert got == want
    assert len(made) == 2
    (jparams,), (tparams,) = ([g["params"] for g in o.param_groups]
                              for o in made)
    assert len(jparams) == len(tparams) == 18
    for a, b in zip(jparams, tparams):
        assert torch.equal(a, b)


@pytest.mark.parametrize("algo", ["trpo", "ppo", "vpg"])
@pytest.mark.parametrize("anil", [False, True])
def test_reference_rl_equals_the_script_bit_for_bit(algo, anil):
    cfg = {**check.default_rl_cfg(algo), **TINY_RL, "anil": anil}
    train = {"trpo": "train_maml_trpo", "ppo": "train_maml_ppo",
             "vpg": "train_maml_vpg"}[algo]
    want = getattr(jrepro, train)(dict(cfg), 7)
    got = getattr(reference_rl, train)(dict(cfg), 7)
    assert got == want
    assert all(np.isfinite(got))


def test_reference_rl_keeps_every_function_of_the_script():
    names = {n for n in dir(jrepro) if not n.startswith("__")}
    assert names <= set(dir(reference_rl))


@pytest.mark.parametrize("algo", ["trpo", "ppo", "vpg"])
def test_default_rl_cfg_is_the_scripts(algo):
    assert check.default_rl_cfg(algo) == jpc.default_rl_cfg(algo)


class _Parsed(Exception):
    pass


def _jax_parser(monkeypatch) -> argparse.ArgumentParser:
    """The parser that ``scripts/parity_check.py:main`` builds, caught as it
    parses."""
    def catch(self, *a, **kw):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed) as caught:
        jpc.main()
    monkeypatch.undo()
    return caught.value.args[0]


def _options(parser) -> dict:
    return {a.dest: (a.option_strings, a.default, a.type, a.choices,
                     a.nargs, a.const) for a in parser._actions}


def test_flags_and_defaults_are_the_scripts(monkeypatch):
    want = _options(_jax_parser(monkeypatch))
    got = _options(check.argparser())
    extra = set(got) - set(want)
    assert extra == {"reference_device"}
    assert {k: got[k] for k in want} == want
    vision = check.parse_args([])
    assert (vision.iters, vision.meta_batch, vision.eval_tasks,
            vision.inner_lr, vision.outer_lr, vision.adapt_steps,
            vision.seed, vision.dataset) == (150, 16, 256, 0.5, 0.003, 1,
                                             42, "omni")
    assert vision.reference_device == "cpu"
    rl = check.parse_args(["--rl", "trpo"])
    assert (rl.iters, rl.meta_batch, rl.eval_tasks, rl.inner_lr,
            rl.outer_lr) == (30, None, None, None, None)


def test_eval_covers_exactly_eval_tasks(images, monkeypatch):
    """37 tasks: one batch of 32 and one of 5, averaged by weight."""
    sizes, metrics = [], []
    sample = check.sample_task_batch
    make_eval = check.make_meta_eval

    def recording_sample(gen, ds, ways, shots, n):
        sizes.append(n)
        return sample(gen, ds, ways, shots, n)

    def recording_eval(fa):
        ev = make_eval(fa)

        def run(*a):
            out = ev(*a)
            metrics.append(float(out["metric"]))
            return out
        return run

    monkeypatch.setattr(check, "sample_task_batch", recording_sample)
    monkeypatch.setattr(check, "make_meta_eval", recording_eval)
    train, test = check.load_vision_data("omni", "cpu")
    acc, launches = check.run_port(train, test, 1, 2, 0.5, 0.003, 1, 37, 42,
                                   device="cpu")
    assert sizes == [2, 32, 5]
    assert len(launches["meta_step"]) == 1 and len(launches["eval"]) == 2
    assert acc == float(np.average(metrics, weights=[32, 5]))


def test_paired_pre_evaluation_repeats_itself():
    """With no training step the post-training meta-test draws what the
    pre-training one drew, so the two are equal; a meta-test on the
    generator as the first one left it is not."""
    cfg = {**check.default_rl_cfg("trpo"), **TINY_RL, "num_iterations": 0}
    post, pre, launches = check.run_port_rl("trpo", cfg, 3, device="cpu")
    assert post == pre
    assert launches["train"] == []
    from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
    from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig
    from exploring_meta_tpu_torch.rl.evaluate import meta_test
    policy = DiagNormalPolicy(2, 2)
    params = policy.init(torch.Generator().manual_seed(3))
    rl_cfg = RLConfig(adapt_batch_size=2, max_path_length=8, inner_lr=0.05,
                      flat_timestep=True, value_reg=2.0)
    gen = torch.Generator().manual_seed(1003)
    first = meta_test("trpo", "Particles2D-v1", policy, params, rl_cfg, 2,
                      gen, seed=3)["mean_reward"]
    again = meta_test("trpo", "Particles2D-v1", policy, params, rl_cfg, 2,
                      gen, seed=3)["mean_reward"]
    assert first == pre
    assert again != first


def test_port_rl_uses_reference_exact_semantics(monkeypatch):
    """Exact mode sets both D9 switches (flat timestep, ridge 2.0);
    ``--improved`` reverts both."""
    seen = []

    def fake_meta_test(algo, env, policy, params, cfg, n_tasks, gen, seed):
        seen.append((cfg.flat_timestep, cfg.value_reg, cfg.anil))
        return {"mean_reward": 0.0}

    monkeypatch.setattr(check, "meta_test", fake_meta_test)
    cfg = {**check.default_rl_cfg("ppo"), **TINY_RL, "num_iterations": 0}
    check.run_port_rl("ppo", cfg, 0, device="cpu")
    check.run_port_rl("ppo", cfg, 0, exact=False, anil=True, device="cpu")
    assert seen == [(True, 2.0, False)] * 2 + [(False, 1e-5, True)] * 2


def _script_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_rl_result_line_is_the_scripts(capsys, monkeypatch):
    """The same four rewards give the script's line, keys renamed, with
    its ``diff`` and ``rel_diff``."""
    rewards = (-21.3456, -38.91234, -23.5678, -37.1111)
    monkeypatch.setattr(jpc, "run_jax_rl", lambda *a, **k: rewards[:2])
    monkeypatch.setattr(jpc, "run_torch_rl", lambda *a, **k: rewards[2:])
    monkeypatch.setattr(check, "run_port_rl",
                        lambda *a, **k: (*rewards[:2], {}))
    monkeypatch.setattr(check, "run_torch_rl", lambda *a, **k: rewards[2:])
    argv = ["--rl", "vpg", "--anil", "--iters", "3", "--meta_batch", "4",
            "--eval_tasks", "5", "--outer_lr", "0.01"]
    monkeypatch.setattr(sys, "argv", ["parity_check.py"] + argv)
    jpc.main()
    want = _script_json(capsys)
    monkeypatch.setenv("EMT_FORCE_CPU", "1")
    cli.parity_check(argv)
    got = _script_json(capsys)
    assert got.pop("device") == {"port": "cpu", "reference": "cpu"}
    assert got.pop("reference_threads") == 1
    assert got == {k.replace("jax_", "port_"): v for k, v in want.items()}
    assert set(got) == {"algo", "anil", "mode", "port_rew", "torch_rew",
                        "port_pre", "torch_pre", "diff", "rel_diff", "cfg"}


@pytest.mark.parametrize("argv", [["--iters", "1"], ["--rl", "ppo"]],
                         ids=["vision", "rl"])
def test_reference_runs_on_its_threads(argv, monkeypatch):
    """The reproduction runs on ``REFERENCE_THREADS`` intra-op threads
    and the count is restored after it; the port's side keeps the
    caller's."""
    seen = []

    def record(result):
        def run(*a, **k):
            seen.append(torch.get_num_threads())
            return result
        return run

    monkeypatch.setattr(check, "run_port",
                        lambda *a, **k: (record((0.5, {}))()))
    monkeypatch.setattr(check, "run_port_rl",
                        lambda *a, **k: (*record((-20.0, -30.0))(), {}))
    monkeypatch.setattr(check.reference_vision, "run_torch", record(0.5))
    monkeypatch.setattr(check, "run_torch_rl", record((-21.0, -31.0)))
    before = torch.get_num_threads()
    monkeypatch.setattr(check, "REFERENCE_THREADS", 3)
    res = check.main(argv, device="cpu")
    assert seen == [before, 3]
    assert torch.get_num_threads() == before
    assert res["reference_threads"] == 3


def test_vision_result_line_is_the_scripts(capsys, monkeypatch):
    monkeypatch.setattr(jpc, "run_jax", lambda *a, **k: 0.91796875)
    monkeypatch.setattr(jpc, "run_torch", lambda *a, **k: 0.9140625)
    monkeypatch.setattr(check, "run_port",
                        lambda *a, **k: (0.91796875, {}))
    monkeypatch.setattr(check.reference_vision, "run_torch",
                        lambda *a, **k: 0.9140625)
    argv = ["--anil", "--iters", "1"]
    monkeypatch.setattr(sys, "argv", ["parity_check.py"] + argv)
    jpc.main()
    want = _script_json(capsys)
    monkeypatch.setenv("EMT_FORCE_CPU", "1")
    cli.parity_check(argv)
    got = _script_json(capsys)
    assert got.pop("device") == {"port": "cpu", "reference": "cpu"}
    assert got.pop("reference_threads") == 1
    assert got == {k.replace("jax_", "port_"): v for k, v in want.items()}


@pytest.mark.parametrize("argv", [
    ["--iters", "2", "--meta_batch", "2", "--eval_tasks", "3"],
    ["--rl", "trpo", "--iters", "1", "--meta_batch", "2",
     "--eval_tasks", "2"]], ids=["vision", "rl"])
def test_parity_check_runs_on_the_cpu_when_asked(argv, capsys, monkeypatch):
    monkeypatch.setenv("EMT_FORCE_CPU", "1")
    res = cli.parity_check(argv)
    printed = _script_json(capsys)
    assert {k: res[k] for k in printed} == printed
    values = ([printed["port_acc"], printed["torch_acc"]] if "port_acc"
              in printed else [printed["port_rew"], printed["torch_rew"],
                               printed["port_pre"], printed["torch_pre"]])
    assert np.isfinite(values).all()
    # on the CPU the kernels' plain twins run, and they count nothing
    assert all(n == 0 for d in res["launches"].get("meta_step", [])
               for n in d.values())


def test_parity_check_without_a_card_raises(monkeypatch):
    monkeypatch.delenv("EMT_FORCE_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.parity_check(["--iters", "1", "--meta_batch", "1",
                          "--eval_tasks", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.parity_check(["--rl", "vpg", "--iters", "1"])
