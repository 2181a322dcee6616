"""The analysis tier of the PyTorch port against the JAX package, on the
CPU: the vision CL matrix and the representation-change probes on the
task pools that JAX's ``run_cl_exp`` / ``run_rep_exp`` draw (replayed from
their keys with JAX's sampler, then fed to both sides as numpy), the
eval CLIs from argv, and ``make_env``'s signature.

Small: CNN4-Omniglot at hidden 8 (ANIL: its spec, hidden 32), 5-way
1-shot, 4 CL tasks. Tolerances: adapted params within 1e-5 of max|params|
over the tree, logits within 1e-5 of max|logits| (the two float32 paths
differ in summation order only); an accuracy entry may differ from JAX's
only by queries whose top two logits lie within 2e-5 of max|logits| (a
tie flip), and those are counted; CCA values within 1e-5 (their
covariances are well conditioned here: 10 variables over 32 or 1,568
datapoints).
"""

import os

import jax
import numpy as np
import pytest
import torch

from exploring_meta_tpu import models as jmodels
from exploring_meta_tpu import rl as jrl
from exploring_meta_tpu import tasks as jtasks
from exploring_meta_tpu.adapt.maml import inner_sgd as jinner_sgd
from exploring_meta_tpu.analysis import cl as jcl
from exploring_meta_tpu.analysis import rc as jrc
from exploring_meta_tpu.envs.factory import make_env as jmake_env
from exploring_meta_tpu.ops.losses import cross_entropy as jxent
from exploring_meta_tpu.tasks.sampler import sample_task
from exploring_meta_tpu_torch import cli
from exploring_meta_tpu_torch.analysis import cl as tcl
from exploring_meta_tpu_torch.analysis import rc as trc
from exploring_meta_tpu_torch.envs.factory import make_env
from exploring_meta_tpu_torch.models import cnn4 as tcnn
from exploring_meta_tpu_torch.utils.bridge import params_to_numpy
from exploring_meta_tpu_torch.utils.config import (
    RLScriptConfig, VisionConfig,
)
from exploring_meta_tpu_torch.utils.experiment import Experiment
from exploring_meta_tpu_torch.utils.tree import tree_items

WAYS, SHOTS, N_TASKS, LR = 5, 1, 4, 0.1
TOL, FLIP_MARGIN, CCA_TOL = 1e-5, 2e-5, 1e-5
SPECS = {False: (jmodels.omniglot_spec(WAYS, hidden=8),
                 tcnn.omniglot_spec(WAYS, hidden=8)),
         True: (jmodels.anil_omniglot_spec(WAYS),
                tcnn.anil_omniglot_spec(WAYS))}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these small runs only lose to the contention of
    several test workers' thread pools on the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def test_ds():
    return jtasks.load_omniglot(seed=0, synthetic=True,
                                synthetic_classes=30)[2]


def _jax_pool(key, ds, n):
    """The pool JAX's run_cl_exp / run_rep_exp draw from ``key``: its key
    splits replayed with its sampler -> numpy ``(data [n, N, ...], labels
    [n, N])``."""
    datas, labels = [], []
    for _ in range(n):
        key, k = jax.random.split(key)
        d, y = sample_task(k, ds.images, WAYS, SHOTS, ds.invert,
                           ds.rotations)
        datas.append(np.asarray(d))
        labels.append(np.asarray(y))
    return np.stack(datas), np.stack(labels)


def _split(x, shots=SHOTS, ways=WAYS):
    idx = np.arange(shots * ways) * 2
    return x[:, idx], x[:, idx + 1]


def _max_abs(tree) -> float:
    return max(float(np.abs(np.asarray(v)).max()) for _, v in
               tree_items(tree))


def _jax_rows(anil, jparams, data, labels, setting):
    """JAX's adapted params and eval logits of every row, computed with its
    own functions on the same pool (what run_cl_exp computes inside)."""
    jspec = SPECS[anil][0]
    if anil:
        data = np.stack([np.asarray(jmodels.cnn4_features(jparams, jspec, d))
                         for d in data])
        adapt_params = jparams["head"]
        fwd = lambda head, x: jmodels.cnn4_head_apply({"head": head}, x)
    else:
        adapt_params = jparams
        fwd = lambda p, x: jmodels.cnn4_apply(p, jspec, x)
    (xs, xq), (ys, yq) = _split(data), _split(labels)
    ex = xs if setting == 1 else xq
    loss = lambda p, b: jxent(fwd(p, b[0]), b[1])
    adapted, logits = [], []
    for i in range(data.shape[0]):
        a = jinner_sgd(loss, adapt_params, (xs[i], ys[i]), LR, 1)
        adapted.append(a)
        logits.append(np.stack([np.asarray(fwd(a, e)) for e in ex]))
    return adapted, np.stack(logits)


@pytest.mark.parametrize("anil", [False, True], ids=["maml", "anil"])
@pytest.mark.parametrize("setting", [1, 2])
def test_cl_matrix_matches_jax_on_its_pool(tmp_path, test_ds, anil, setting):
    jspec, tspec = SPECS[anil]
    tparams = tcnn.init_cnn4(torch.Generator().manual_seed(setting), tspec,
                             device="cpu")
    jparams = jax.tree_util.tree_map(jax.numpy.asarray,
                                     params_to_numpy(tparams))
    key = jax.random.key(10 * setting + anil)
    kw = {}
    if anil:
        kw = dict(features_fn=lambda p, x: jmodels.cnn4_features(p, jspec, x),
                  head_apply=jmodels.cnn4_head_apply)
    want, _ = jcl.run_cl_exp(
        str(tmp_path), lambda p, x: jmodels.cnn4_apply(p, jspec, x), jparams,
        test_ds, WAYS, SHOTS, key, cl_params={"adapt_steps": 1,
                                              "inner_lr": LR,
                                              "n_tasks": N_TASKS},
        setting=setting, **kw)
    data, labels = _jax_pool(key, test_ds, N_TASKS)
    if anil:
        kw = dict(features_fn=lambda p, x: tcnn.cnn4_features(p, tspec, x),
                  head_apply=tcnn.cnn4_head_apply)
    got = tcl.cl_matrix(lambda p, x: tcnn.cnn4_apply(p, tspec, x), tparams,
                        torch.from_numpy(data), torch.from_numpy(labels),
                        WAYS, SHOTS, LR, 1, setting=setting, **kw)
    j_adapted, j_logits = _jax_rows(anil, jparams, data, labels, setting)

    top = max(_max_abs(a) for a in j_adapted)
    err = max(float(np.abs(v.numpy() - np.asarray(w)).max())
              for a, b in zip(got.adapted, j_adapted)
              for (_, v), (_, w) in zip(tree_items(a), tree_items(b)))
    assert err <= TOL * top, (err, top)
    logits = got.logits.numpy()
    scale = float(np.abs(j_logits).max())
    assert float(np.abs(logits - j_logits).max()) <= TOL * scale

    # each differing entry is explained by near-tie queries
    ey = _split(labels)[0 if setting == 1 else 1]
    srt = np.sort(logits, axis=-1)
    near_tie = (srt[..., -1] - srt[..., -2]) <= FLIP_MARGIN * scale
    n_eval = ey.shape[1]
    flips = np.rint(np.abs(got.acc - want) * n_eval).astype(int)
    assert (flips <= near_tie.sum(-1)).all(), (got.acc, want)
    print(f"CL matrix ({'anil' if anil else 'maml'}, setting {setting}): "
          f"{int(flips.sum())} tie flips")
    np.testing.assert_allclose(
        got.acc, (logits.argmax(-1) == ey[None]).mean(-1), rtol=0, atol=1e-7)
    assert got.acc.shape == (N_TASKS, N_TASKS)


def test_run_cl_exp_artifacts(tmp_path, test_ds):
    """The run_* composition: JAX's files with their keys; a pool drawn by
    the port's sampler from its own generator."""
    from exploring_meta_tpu_torch.tasks.datasets import load_omniglot
    _, _, ds = load_omniglot(seed=0, synthetic=True, synthetic_classes=30,
                             device="cpu")
    tspec = SPECS[False][1]
    params = tcnn.init_cnn4(torch.Generator().manual_seed(0), tspec,
                            device="cpu")
    acc, res = tcl.run_cl_exp(
        str(tmp_path), lambda p, x: tcnn.cnn4_apply(p, tspec, x), params, ds,
        WAYS, SHOTS, torch.Generator().manual_seed(1),
        cl_params={"adapt_steps": 1, "inner_lr": LR, "n_tasks": 3})
    assert acc.shape == (3, 3) and ((0 <= acc) & (acc <= 1)).all()
    assert sorted(os.listdir(tmp_path / "cl_exp")) == [
        "acc_matrix.out", "cl_params.json", "cl_res.json"]
    assert set(res) == {"av_acc", "fwt", "rem", "bwt_plus"}
    np.testing.assert_allclose(
        np.loadtxt(tmp_path / "cl_exp" / "acc_matrix.out"), acc, atol=5e-3)


def test_rep_exp_matches_jax_on_its_pool(tmp_path, test_ds):
    jspec, tspec = SPECS[False]
    tparams = tcnn.init_cnn4(torch.Generator().manual_seed(4), tspec,
                             device="cpu")
    jparams = jax.tree_util.tree_map(jax.numpy.asarray,
                                     params_to_numpy(tparams))
    rep_params = {"adapt_steps": 1, "inner_lr": LR, "n_tasks": 3,
                  "layers": [1, 4]}
    key = jax.random.key(7)
    want = jrc.run_rep_exp(
        str(tmp_path), lambda p, x: jmodels.cnn4_apply(p, jspec, x),
        lambda p, x, layer: jmodels.get_rep_layer(p, jspec, x, layer),
        jparams, test_ds, WAYS, SHOTS, key, rep_params=rep_params)
    data, labels = _jax_pool(key, test_ds, 3)
    got = trc.rep_similarities(
        lambda p, x: tcnn.cnn4_apply(p, tspec, x),
        lambda p, x, layer: tcnn.get_rep_layer(p, tspec, x, layer), tparams,
        torch.from_numpy(data), torch.from_numpy(labels), WAYS, SHOTS,
        rep_params)
    assert set(got) == set(want) == {"cca"}
    assert set(got["cca"]) == {"1", "4"}
    for layer in ("1", "4"):
        np.testing.assert_allclose(got["cca"][layer], want["cca"][layer],
                                   rtol=0, atol=CCA_TOL)


def test_make_env_signature_returns_what_jax_does():
    import inspect
    from exploring_meta_tpu.envs.factory import make_env as jmake
    assert list(inspect.signature(make_env).parameters) == \
        list(inspect.signature(jmake).parameters)
    kw = dict(workers=3, seed=1, test=True, max_path_length=50)
    env, is_device = make_env("Particles2D-v1", **kw)
    jenv, jis_device = jmake_env("Particles2D-v1", **kw)
    assert is_device is jis_device is True
    assert type(env).__name__ == type(jenv).__name__
    assert tuple(env) == tuple(jenv)
    for name in ("AntDirection-v1", "ML10", "ML1_push"):
        with pytest.raises(NotImplementedError, match="host envs"):
            make_env(name)


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """Run dirs written by the port's trainers on the CPU: a 2-iteration
    VisionTrainer run (meta-batch 2) and a 2-iteration MAML-TRPO run
    (3 tasks x 4 episodes x horizon 10, 3 eval tasks)."""
    from exploring_meta_tpu_torch.trainers.rl import RLTrainer
    from exploring_meta_tpu_torch.trainers.vision import VisionTrainer
    tmp = str(tmp_path_factory.mktemp("runs")) + "/"
    vis = VisionTrainer(VisionConfig(num_iterations=2, meta_batch_size=2,
                                     save_every=1, synthetic=True),
                        path=tmp, device="cpu")
    vis.run()
    rl = RLTrainer(RLScriptConfig(num_iterations=2, meta_batch_size=3,
                                  adapt_batch_size=4, max_path_length=10,
                                  n_eval_tasks=3, save_every=1),
                   path=tmp, device="cpu")
    rl.run()
    return vis.model_path, rl.model_path


def test_eval_clis_on_the_cpu_only_when_asked(run_dirs, monkeypatch):
    vision, rl = run_dirs
    monkeypatch.delenv("EMT_FORCE_CPU", raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.eval_vision([vision, "--synthetic"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.eval_rl([rl])
    monkeypatch.setenv("EMT_FORCE_CPU", "1")
    out = cli.eval_vision([vision, "--synthetic", "--no_cl"])
    assert set(out) == {"test_acc", "ckpnt_results", "rep_res",
                        "cca_through_time"}
    assert set(out["ckpnt_results"]) == {0, 1}
    assert all(0.0 <= v <= 1.0 for v in out["cca_through_time"])
    out = cli.eval_rl([rl, "--cl", "--rc", "--checkpoint", "1"])
    assert set(out) == {"eval", "cl_res_rew", "cl_res_suc", "rep_res",
                        "cca_through_time"}
    assert len(out["eval"]["tasks_rewards"]) == 3
    assert out["eval"]["rewards_per_task"] == {}
    assert os.path.exists(os.path.join(rl, "cl_exp", "cl_rew_matrix.out"))


@pytest.mark.parametrize("flags", [["--workers", "2"], ["--task_batch"],
                                   ["--host_policy", "cpu"]])
def test_eval_rl_host_env_flags_raise(run_dirs, monkeypatch, flags):
    monkeypatch.setenv("EMT_FORCE_CPU", "1")
    with pytest.raises(NotImplementedError, match="host envs"):
        cli.eval_rl([run_dirs[1]] + flags)


@pytest.mark.parametrize("flags", [["--each3"], ["--task", "door-close"]])
def test_eval_rl_task_selection_on_a_device_env_raises_as_jax(
        run_dirs, monkeypatch, flags):
    monkeypatch.setenv("EMT_FORCE_CPU", "1")
    with pytest.raises(ValueError) as want:
        jrl.evaluate("trpo", None, None, None, None, None,
                     "door-close" if "--task" in flags else 3,
                     jax.random.key(0), device_env=True,
                     each3="--each3" in flags)
    with pytest.raises(ValueError) as got:
        cli.eval_rl([run_dirs[1]] + flags)
    assert str(got.value) == str(want.value)


def test_eval_rl_on_a_host_env_run_dir_raises(tmp_path):
    exp = Experiment("maml_trpo", "ML10", RLScriptConfig(env="ML10")
                     .to_params(), path=str(tmp_path) + "/")
    exp.save_logs_to_file()
    from exploring_meta_tpu_torch.analysis import eval_rl
    with pytest.raises(NotImplementedError, match="host envs"):
        eval_rl.run(exp.model_path, device="cpu")
