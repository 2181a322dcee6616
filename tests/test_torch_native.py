"""The port's native env-stepping service (``native/vecenv.cpp`` through
``native/binding.py``) against the JAX package's: the same source, the
same Particles2D bit for bit, the same checks before a pointer reaches C,
the Python-env pool's contract; the build into ``build/`` by the source's
hash, safe when processes build at once, and one printed line with
``None`` where ``g++`` is missing."""

import filecmp
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_meta_tpu.envs.particles2d import Particles2D as JEnv
from exploring_meta_tpu.native import binding as jbinding
from exploring_meta_tpu_torch.cuda import build
from exploring_meta_tpu_torch.envs.particles2d import Particles2D
from exploring_meta_tpu_torch.native import binding

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)


class PointEnv:
    """A Python env of the host-env protocol: a point pushed by its action;
    ``fail_at`` makes one step raise."""

    obs_size, action_size = 3, 2

    def __init__(self, fail_at=None, obs_size=3):
        self.obs_size = obs_size
        self.fail_at, self.t, self.x, self.seed = fail_at, 0, np.zeros(2), None

    def reset(self, seed=None):
        self.seed, self.t, self.x = seed, 0, np.zeros(2)
        return np.zeros(self.obs_size)

    def step(self, action):
        self.t += 1
        if self.t == self.fail_at:
            raise RuntimeError("physics blew up")
        self.x = self.x + np.asarray(action)
        obs = np.concatenate([self.x, [self.t]])[:self.obs_size]
        return obs, -float(self.x @ self.x), self.t >= 3, False, 0.5


def test_vecenv_source_is_the_jax_package_s_byte_for_byte():
    assert filecmp.cmp(binding.SRC, os.path.join(
        os.path.dirname(jbinding.__file__), "vecenv.cpp"), shallow=False)
    assert os.path.dirname(binding.SRC) == os.path.join(
        os.path.abspath(REPO), "exploring_meta_tpu_torch", "native")


def test_library_is_built_into_build_by_the_source_s_hash():
    path = binding.library_path()
    assert os.path.dirname(path) == build.BUILD_DIR
    assert os.path.basename(path) == os.path.basename(jbinding._lib_path())
    assert binding.load_vecenv_library() is not None
    assert os.path.exists(path) and binding.native_available()
    assert binding.effective_cpus() == len(os.sched_getaffinity(0))


def test_processes_building_at_once_each_load_the_library(tmp_path):
    """Two processes building into an empty directory at once: each
    compiles to a private name and renames it into place, so both load a
    whole library and no temporary file stays."""
    code = ("import sys; sys.path.insert(0, {repo!r});"
            "from exploring_meta_tpu_torch.cuda import build;"
            "build.BUILD_DIR = {dir!r};"
            "from exploring_meta_tpu_torch.native import binding as b;"
            "e = b.NativeVecEnv(n_envs=2);"
            "print(e.reset([0.1, 0.2]).shape)").format(
                repo=os.path.abspath(REPO), dir=str(tmp_path))
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert outs == ["(2, 2)\n"] * 2
    assert [f for f in os.listdir(tmp_path)] == [
        os.path.basename(binding.library_path())]


def test_without_gpp_one_line_and_none_and_native_raises(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    from exploring_meta_tpu_torch.envs.host import HostVecEnv
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(binding, "_LIB_CACHE", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    assert binding.load_vecenv_library() is None
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and "native vecenv unavailable" in err
    assert os.listdir(tmp_path) == []
    with pytest.raises(RuntimeError, match="unavailable"):
        binding.NativeVecEnv(n_envs=2)
    with pytest.raises(RuntimeError, match="unavailable"):
        HostVecEnv(PointEnv, 2, backend="native", n_threads=2)
    vec = HostVecEnv(PointEnv, 2, backend="auto", n_threads=2)
    assert vec.backend == "python"
    assert "falling back to sequential stepping" in capsys.readouterr().err


def test_particles2d_equals_the_jax_binding_bit_for_bit():
    rng = np.random.default_rng(0)
    tasks = rng.uniform(-0.5, 0.5, (4, 2))
    ours, theirs = (binding.NativeVecEnv(n_envs=4),
                    jbinding.NativeVecEnv(n_envs=4))
    assert (ours.obs_size, ours.action_size) == (theirs.obs_size,
                                                 theirs.action_size) == (2, 2)
    np.testing.assert_array_equal(ours.reset(tasks), theirs.reset(tasks))
    for _ in range(40):
        a = rng.uniform(-0.2, 0.2, (4, 2))
        for x, y in zip(ours.step(a), theirs.step(a)):
            assert x.dtype == y.dtype == np.float64
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("goal", [(0.31, -0.17), (0.008, 0.008)])
def test_particles2d_matches_the_device_env(goal):
    """The C++ Particles2D against the port's device env (float32) and
    JAX's, as JAX's own test holds it; (0.008, 0.008) is the corner where
    l2l's box test ends the episode and a disk test would not (D5)."""
    task = torch.tensor(goal)
    state, _ = Particles2D().reset(task, 1)
    jstate, _ = JEnv().reset(jax.random.key(0), jnp.asarray(goal))
    nat = binding.NativeVecEnv(n_envs=1)
    nat.reset(np.asarray(goal))
    rng = np.random.default_rng(1)
    for t in range(30):
        a = rng.uniform(-0.2, 0.2, 2) if goal[0] > 0.1 else np.zeros(2)
        state, obs, rew, done, suc = Particles2D().step(
            state, torch.tensor(a, dtype=torch.float32)[None], task)
        jstate, jobs, jrew, jdone, _ = JEnv().step(jstate, jnp.asarray(a),
                                                  jnp.asarray(goal))
        nobs, nrew, ndone, nsuc = nat.step(a[None])
        np.testing.assert_allclose(obs[0].numpy(), nobs[0], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(float(rew[0]), nrew[0], rtol=1e-5,
                                   atol=1e-6)
        assert float(done[0]) == ndone[0] == float(jdone)
        assert float(suc[0]) == nsuc[0]
    if goal[0] < 0.1:
        assert ndone[0] == 1.0


def test_shapes_are_checked_before_a_pointer_reaches_c():
    ours, theirs = (binding.NativeVecEnv(n_envs=3),
                    jbinding.NativeVecEnv(n_envs=3))
    for bad in (np.zeros((2, 2)), np.zeros((3, 3))):
        with pytest.raises(ValueError) as got:
            ours.reset(bad)
        with pytest.raises(ValueError) as want:
            theirs.reset(bad)
        assert str(got.value) == str(want.value)
    ours.reset(np.zeros(2))
    theirs.reset(np.zeros(2))
    for bad in (np.zeros((3, 3)), np.zeros((2, 2)), np.zeros(6)):
        with pytest.raises(ValueError) as got:
            ours.step(bad)
        with pytest.raises(ValueError) as want:
            theirs.step(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown native env"):
        binding.NativeVecEnv("cartpole", n_envs=2)
    busy = binding.NativeVecEnv("busy", n_envs=2, busy_us=10.0)
    np.testing.assert_array_equal(busy.reset(np.array([[1.0, 0], [2, 0]])),
                                  [[1.0, 0.0], [2.0, 0.0]])
    obs, rew, done, _ = busy.step(np.ones((2, 2)))
    np.testing.assert_array_equal(obs[:, 0], [2.0, 3.0])
    np.testing.assert_array_equal(rew, [-4.0, -9.0])


def test_python_env_pool_contract():
    """Slot i resets with ``seed + i``; a step returns float64 ``[E, ...]``
    arrays of the envs' own results; the pool's threads step every env."""
    envs = [PointEnv() for _ in range(5)]
    pool = binding.PythonEnvPool(envs, n_threads=3)
    assert (pool.obs_size, pool.action_size, pool.n_envs) == (3, 2, 5)
    obs = pool.reset(seed=7)
    assert obs.shape == (5, 3) and obs.dtype == np.float64
    assert [e.seed for e in envs] == [7, 8, 9, 10, 11]
    pool.reset()
    assert [e.seed for e in envs] == [None] * 5
    acts = np.arange(10, dtype=np.float64).reshape(5, 2)
    obs, rew, done, suc = pool.step(acts)
    np.testing.assert_array_equal(obs[:, :2], acts)
    np.testing.assert_array_equal(rew, -(acts ** 2).sum(1))
    np.testing.assert_array_equal(done, 0.0)
    np.testing.assert_array_equal(suc, 0.5)
    pool.step(acts)
    _, _, done, _ = pool.step(acts)
    np.testing.assert_array_equal(done, 1.0)
    with pytest.raises(ValueError, match=r"actions must be \[5, 2\]"):
        pool.step(np.zeros((5, 3)))


def test_python_env_pool_raises_what_an_env_raised():
    pool = binding.PythonEnvPool([PointEnv(), PointEnv(fail_at=2)],
                                 n_threads=2)
    pool.reset(seed=0)
    pool.step(np.zeros((2, 2)))
    with pytest.raises(RuntimeError, match="physics blew up"):
        pool.step(np.zeros((2, 2)))
    pool.reset(seed=0)  # the error is cleared: the pool goes on
    pool.step(np.zeros((2, 2)))
    wrong = binding.PythonEnvPool([PointEnv(), PointEnv(obs_size=2)])
    with pytest.raises(ValueError, match="env 1 reset obs size 2 != 3"):
        wrong.reset()
