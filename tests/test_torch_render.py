"""Policy rendering (``render.py``, ``cli.py:render_policy``) against
``scripts/render_metaworld.py``, on the CPU.

Two run dirs: a tiny MuJoCo Ant run trained by the port's CLI, and a
Meta-World ML10 run on ``tests/fake_metaworld.py`` (MAML and ANIL
policies). Rendering needs a GL stack that this machine may lack, so a
run must pass whether ``render()`` returns frames or raises; each branch
is also forced once with a stub: no GL (reporting returns only), frames
written as a GIF, and ``.npy`` frames when the GIF cannot be encoded. A
device env is refused with the JAX script's message.
"""

import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from exploring_meta_tpu_torch import cli, render
from exploring_meta_tpu_torch.envs.host import AntDirectionEnv
from exploring_meta_tpu_torch.trainers.rl import build_policy
from exploring_meta_tpu_torch.utils.experiment import flatten_params

SCRIPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       os.pardir, "scripts")
STEPS = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: this CPU build's multi-threaded solve of Ant's
    baseline fit has been seen to hang under several test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ant_run(tmp_path_factory):
    """A MAML-TRPO run dir on AntDirection-v1 from the port's CLI: one
    iteration of one task, one episode of STEPS steps."""
    tmp = tmp_path_factory.mktemp("ant")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        mp.setenv("EMT_FORCE_CPU", "1")
        cli.maml_trpo(["--env", "AntDirection-v1", "--num_iterations", "1",
                       "--meta_batch_size", "1", "--adapt_batch_size", "1",
                       "--max_path_length", str(STEPS),
                       "--n_eval_tasks", "1"])
    (run,) = os.listdir(tmp / "results")
    return str(tmp / "results" / run)


def _run_dir(path, config: dict, env) -> str:
    """A run dir holding ``config`` and a fresh ``model.npz`` of the
    policy that ``config`` names on ``env``."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "logger.json"), "w") as f:
        json.dump({"config": config}, f)
    policy = build_policy(env, config["algo"].startswith("anil"),
                          fc_neurons=config.get("fc_neurons", 100))
    params = policy.init(torch.Generator().manual_seed(1), device="cpu")
    np.savez(os.path.join(path, "model.npz"), **flatten_params(params))
    return str(path)


def _episode_lines(out: str) -> list:
    return re.findall(r"^episode \d+: return -?[\d.]+$", out, re.M)


def _jax_render(argv, capsys, monkeypatch):
    sys.path.insert(0, SCRIPTS)
    try:
        import render_metaworld as jrender
    finally:
        sys.path.remove(SCRIPTS)
    monkeypatch.setattr(sys, "argv", ["render_metaworld.py"] + argv)
    capsys.readouterr()
    jrender.main()
    return capsys.readouterr().out


def test_ant_run_renders_or_reports_returns(ant_run, capsys, monkeypatch,
                                            tmp_path):
    """Held against the JAX script on the same run dir: the same episode
    lines (the returns differ: each package draws its own action noise)
    and the same rendering outcome."""
    want = _jax_render([ant_run, "--episodes", "2"], capsys, monkeypatch)
    monkeypatch.setenv("EMT_FORCE_CPU", "1")
    res = cli.render_policy([ant_run, "--episodes", "2",
                             "--out", str(tmp_path / "frames")])
    got = capsys.readouterr().out
    assert len(_episode_lines(got)) == len(_episode_lines(want)) == 2
    assert ("rendering unavailable" in got) == (
        "rendering unavailable" in want)
    assert len(res["returns"]) == 2 and np.isfinite(res["returns"]).all()
    if res["frames"]:
        assert os.path.exists(res["written"])
    else:
        assert res["written"] is None


def _stub_render(monkeypatch, fn):
    """Every Ant env's gym env renders with ``fn``."""
    real = AntDirectionEnv.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        self._env.render = fn

    monkeypatch.setattr(AntDirectionEnv, "__init__", init)


def test_no_gl_reports_returns_only(ant_run, capsys, monkeypatch, tmp_path):
    def no_gl():
        raise RuntimeError("no OpenGL context")

    _stub_render(monkeypatch, no_gl)
    res = render.render_policy(ant_run, episodes=2, out=str(tmp_path / "f"),
                               device="cpu")
    out = capsys.readouterr().out
    assert out.count("rendering unavailable (no OpenGL context); "
                     "reporting returns only") == 1
    assert len(_episode_lines(out)) == 2
    assert res["frames"] == 0 and res["written"] is None
    assert not os.path.exists(tmp_path / "f")


def _frames():
    rng = np.random.default_rng(0)
    return lambda: rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)


def test_frames_are_written_as_a_gif(ant_run, capsys, monkeypatch, tmp_path):
    from PIL import Image
    _stub_render(monkeypatch, _frames())
    res = render.render_policy(ant_run, episodes=2, out=str(tmp_path / "f"),
                               device="cpu")
    assert res["frames"] == 2 * STEPS
    assert res["written"] == str(tmp_path / "f" / "rollout.gif")
    with Image.open(res["written"]) as gif:
        assert gif.n_frames == 2 * STEPS
    assert f"wrote {res['written']} ({2 * STEPS} frames)" in (
        capsys.readouterr().out)


def test_frames_fall_back_to_npy(ant_run, capsys, monkeypatch, tmp_path):
    _stub_render(monkeypatch, _frames())
    monkeypatch.setitem(sys.modules, "PIL", None)   # no Pillow
    res = render.render_policy(ant_run, episodes=1, out=str(tmp_path / "f"),
                               device="cpu")
    names = sorted(os.listdir(tmp_path / "f"))
    assert names == [f"frame_{i:05d}.npy" for i in range(STEPS)]
    assert np.load(tmp_path / "f" / names[0]).shape == (8, 8, 3)
    assert res["written"] == str(tmp_path / "f")
    assert f"dumped {STEPS} npy frames" in capsys.readouterr().out


def test_policy_placement(ant_run, capsys, monkeypatch):
    """The params go to the requested device through the host-env
    trainers' placement, with its default mode; without a card and
    without ``EMT_FORCE_CPU`` the command raises."""
    from exploring_meta_tpu_torch.envs import host
    placed = []

    def place(mode, params, gen):
        placed.append((mode, {t.device.type for t in
                              render.tree_leaves(params)}, gen.device.type))
        return host._place_policy(mode, params, gen)

    monkeypatch.setattr(render, "_place_policy", place)
    monkeypatch.setenv("EMT_FORCE_CPU", "1")
    res = cli.render_policy([ant_run, "--episodes", "1"])
    assert placed == [(None, {"cpu"}, "cpu")]
    assert len(res["returns"]) == 1 and np.isfinite(res["returns"]).all()
    monkeypatch.delenv("EMT_FORCE_CPU")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.render_policy([ant_run, "--episodes", "1"])


def test_device_envs_are_refused_as_in_jax(capsys, monkeypatch, tmp_path):
    from exploring_meta_tpu_torch.envs.particles2d import Particles2D
    run = _run_dir(tmp_path / "p2d", {"dataset": "Particles2D-v1",
                                      "seed": 42, "max_path_length": 5,
                                      "algo": "maml_trpo"}, Particles2D())
    with pytest.raises(SystemExit) as want:
        _jax_render([run], capsys, monkeypatch)
    with pytest.raises(SystemExit) as got:
        cli.render_policy([run])
    assert str(got.value) == str(want.value) == (
        "rendering targets host physics envs (AntDirection / Meta-World)")


@pytest.mark.parametrize("algo", ["maml_ppo", "anil_ppo"])
def test_fake_metaworld_run(algo, fake_metaworld, capsys, monkeypatch,
                            tmp_path):
    """A fake-ML10 run dir: the policy of the run's algorithm acts on the
    adapter's first slot until the horizon; the fake env has no
    ``render``, then a stub one whose frames become a GIF."""
    from exploring_meta_tpu_torch.envs.factory import make_env
    config = {"dataset": "ML10", "seed": 42, "max_path_length": 6,
              "algo": algo, "fc_neurons": 100}
    env, _ = make_env("ML10", workers=1, seed=42, max_path_length=6)
    run = _run_dir(tmp_path / algo, config, env)
    res = render.render_policy(run, episodes=2, out=str(tmp_path / "f"),
                               device="cpu")
    out = capsys.readouterr().out
    assert len(_episode_lines(out)) == 2 and "rendering" not in out
    assert res["frames"] == 0 and np.isfinite(res["returns"]).all()
    monkeypatch.setattr(fake_metaworld.FakeSawyerEnv, "render",
                        lambda self: _frames()(), raising=False)
    res = render.render_policy(run, episodes=2, out=str(tmp_path / "f"),
                               device="cpu")
    assert res["frames"] == 2 * 6
    assert res["written"].endswith("rollout.gif")
