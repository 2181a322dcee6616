"""The port's offline evaluation (``eval_vision.run``, ``eval_rl.run``) on
run directories that the JAX package wrote, against what the JAX
package's own ``run`` functions write there.

Each run dir is written by the JAX package's ``Experiment`` (its config,
``model.npz`` and two checkpoints, JAX params at full width), copied, and
evaluated once by ``exploring_meta_tpu.analysis.eval_{vision,rl}.run``
and once by the port's on the CPU. The random streams differ (threefry
against ``torch.Generator``), so the numbers differ; the artifact
contract must not: the same files, and every JSON file with the same
structure (the same keys at every level, lists of the same lengths).
"""

import json
import os
import shutil

import jax
import pytest
import torch

from exploring_meta_tpu import models as jmodels
from exploring_meta_tpu.analysis import eval_rl as jeval_rl
from exploring_meta_tpu.analysis import eval_vision as jeval_vision
from exploring_meta_tpu.envs import Particles2D
from exploring_meta_tpu.trainers.rl import build_policy
from exploring_meta_tpu.utils.config import RLScriptConfig, VisionConfig
from exploring_meta_tpu.utils.experiment import Experiment
from exploring_meta_tpu_torch.analysis import eval_rl, eval_vision

CL = {"adapt_steps": 1, "inner_lr": 0.1, "n_tasks": 3}
REP = {"adapt_steps": 1, "inner_lr": 0.1, "n_tasks": 2, "layers": [4]}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these small runs only lose to the contention of
    several test workers' thread pools on the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_run_dir(root, algo, dataset, config, init):
    """A run dir written by the JAX package: checkpoints 0 and 1, then the
    final model -> two copies of it, (for JAX, for the port)."""
    exp = Experiment(algo, dataset, config.to_params(), path=str(root) + "/")
    for i in range(2):
        exp.save_model_checkpoint(init(jax.random.key(i)), i)
    exp.save_model(init(jax.random.key(2)))
    exp.save_logs_to_file()
    port = exp.model_path + "_port"
    shutil.copytree(exp.model_path, port)
    return exp.model_path, port


def _files(run):
    return sorted(os.path.relpath(os.path.join(d, f), run)
                  for d, _, fs in os.walk(run) for f in fs)


def _shape(x):
    """The structure of a JSON value: keys at every level, list lengths."""
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_shape(v) for v in x]
    return type(x).__name__ if isinstance(x, (str, bool)) else "number"


def _same_contract(jax_run, port_run):
    assert _files(port_run) == _files(jax_run)
    for rel in _files(jax_run):
        if rel.endswith(".json"):
            with open(os.path.join(jax_run, rel)) as f:
                want = json.load(f)
            with open(os.path.join(port_run, rel)) as f:
                got = json.load(f)
            assert _shape(got) == _shape(want), rel


def test_eval_vision_on_a_jax_run_dir_writes_jax_artifacts(tmp_path):
    spec = jmodels.omniglot_spec(5)
    jax_run, port_run = _jax_run_dir(
        tmp_path, "maml_5w1s", "omni",
        VisionConfig(meta_batch_size=2, synthetic=True),
        lambda k: jmodels.init_cnn4(k, spec))
    kw = dict(n_eval_batches=1, cl_params=CL, rep_params=REP, synthetic=True)
    want = jeval_vision.run(jax_run, **kw)
    got = eval_vision.run(port_run, device="cpu", **kw)
    _same_contract(jax_run, port_run)
    assert set(got) == set(want)
    assert 0.0 <= got["test_acc"] <= 1.0
    assert all(0.0 <= v <= 1.0 for v in got["cca_through_time"])


def test_eval_rl_on_a_jax_run_dir_writes_jax_artifacts(tmp_path):
    policy = build_policy(Particles2D(), False)
    jax_run, port_run = _jax_run_dir(
        tmp_path, "maml_trpo", "Particles2D-v1",
        RLScriptConfig(meta_batch_size=2, adapt_batch_size=4,
                       max_path_length=10, n_eval_tasks=3),
        policy.init)
    want = jeval_rl.run(jax_run, run_cl=True, run_rc=True)
    got = eval_rl.run(port_run, run_cl=True, run_rc=True, device="cpu")
    _same_contract(jax_run, port_run)
    assert set(got) == set(want)
    assert got["eval"]["rewards_per_task"] == {}
