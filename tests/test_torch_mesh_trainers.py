"""``--mesh`` on the PyTorch port's trainers and seed sweep, on the CPU.

- ``maml_vision``, ``maml_trpo`` and ``maml_ppo`` at ``--mesh 2``, eager
  and ``--fuse 2``, two iterations each, in one launch of two gloo ranks:
  finite metrics, one run dir (rank 0's), which the JAX package's
  ``load_params`` reads.
- The same six runs in a launch of one rank (the mesh code at world size
  1) equal the runs without a mesh bit for bit: metrics and final params
  (both with one intra-op thread, as each rank takes).
- A ``--mesh 2`` checkpoint resumes at ``--mesh 1``: the resumed row is the
  ``--mesh 2`` run's within 1e-4 (the shards' means are summed in another
  order than the whole batch's).
- ``sweep --vmap_seeds --mesh 2``: each seed's rows equal the unsharded
  one-program sweep's bit for bit.

Tiny: meta-batch 2 (one task a rank), 2 episodes of 5 steps; vision
hidden 64 on the small synthetic Omniglot.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from exploring_meta_tpu.models import cnn4 as jcnn
from exploring_meta_tpu.models.policies import DiagNormalPolicy as JPolicy
from exploring_meta_tpu.utils.experiment import load_params as jload_params
from exploring_meta_tpu_torch import sweep as tsweep
from exploring_meta_tpu_torch.parallel import launch as tlaunch
from exploring_meta_tpu_torch.trainers.rl import RLTrainer
from exploring_meta_tpu_torch.trainers.vision import VisionTrainer
from exploring_meta_tpu_torch.utils.config import RLScriptConfig, VisionConfig

import torch_mesh_workers as W

RL = dict(num_iterations=2, meta_batch_size=2, adapt_batch_size=2,
          max_path_length=5, n_eval_tasks=1, outer_lr=0.01,
          compile_cache="off")
VISION = dict(num_iterations=2, meta_batch_size=2, synthetic=True,
              compile_cache="off")
RUNS = [("vision", "maml", VISION), ("rl", "trpo", RL), ("rl", "ppo", RL)]


def _configs(mesh: int, path: str, **extra) -> list:
    out = []
    for kind, algo, kw in RUNS:
        cls = VisionConfig if kind == "vision" else RLScriptConfig
        for fuse in (1, 2):
            out.append((kind, algo, cls(**kw, mesh=mesh, fuse=fuse, **extra),
                        os.path.join(path, f"{kind}_{algo}_{fuse}") + "/"))
    return out


def _plain(runs) -> list:
    """The runs without a launch, with one intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = []
        for kind, algo, cfg, path in runs:
            trainer = (VisionTrainer(cfg, path=path, device="cpu")
                       if kind == "vision" else
                       RLTrainer(cfg, algo=algo, path=path, device="cpu"))
            result = trainer.run()
            out.append((trainer.model_path, trainer.metrics, result))
        return out
    finally:
        torch.set_num_threads(threads)


def _model(run_dir) -> dict:
    with np.load(os.path.join(run_dir, "model.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh2"))
    runs = _configs(2, path, save_every=1)
    outs = tlaunch.launch(W.run_trainers, 2, args=(runs,), device="cpu")
    assert outs[1]["result"] == [None] * len(runs)
    return runs, outs[0]["result"]


def test_mesh_two_trainers_run_and_write_one_run_dir(two_ranks):
    runs, results = two_ranks
    for (kind, algo, cfg, path), (run_dir, metrics, result) in zip(runs,
                                                                   results):
        assert os.listdir(path) == [os.path.basename(run_dir)]
        rows = {k: v for k, v in metrics.items()
                if k not in ("test_acc", "eval_reward", "eval_success")}
        assert all(len(v) == 2 for v in rows.values()), (algo, cfg.fuse)
        assert all(np.isfinite(x) for v in metrics.values() for x in v)
        with open(os.path.join(run_dir, "metrics.json")) as f:
            assert json.load(f) == metrics
        with open(os.path.join(run_dir, "logger.json")) as f:
            assert json.load(f)["config"]["mesh"] == 2
        template = (jcnn.init_cnn4(jax.random.key(0), jcnn.omniglot_spec(5))
                    if kind == "vision"
                    else JPolicy(2, 2).init(jax.random.key(0)))
        params = jload_params(os.path.join(run_dir, "model.npz"), template)
        assert all(np.isfinite(np.asarray(x)).all()
                   for x in jax.tree_util.tree_leaves(params))
        # fused checkpoints land on chunk ends
        want = ["model_1.npz"] if cfg.fuse > 1 else ["model_0.npz",
                                                     "model_1.npz"]
        assert sorted(os.listdir(os.path.join(run_dir,
                                              "model_checkpoints"))) == want


def test_mesh_one_is_the_run_without_a_mesh_bit_for_bit(tmp_path):
    runs = _configs(1, str(tmp_path / "ranked"))
    ranked = tlaunch.launch(W.run_trainers, 1, args=(runs,),
                            device="cpu")[0]["result"]
    plain = _plain(_configs(1, str(tmp_path / "plain")))
    for (kind, algo, cfg, _), a, b in zip(runs, ranked, plain):
        assert a[1] == b[1], (algo, cfg.fuse)
        ma, mb = _model(a[0]), _model(b[0])
        assert ma.keys() == mb.keys()
        assert all(np.array_equal(ma[k], mb[k]) for k in ma), (algo,
                                                               cfg.fuse)


def test_a_mesh_two_checkpoint_resumes_at_mesh_one(two_ranks, tmp_path):
    runs, results = two_ranks
    (_, _, cfg, _), (run_dir, metrics, _) = runs[0], results[0]
    assert cfg.fuse == 1
    resumed = _plain([("vision", "maml", dataclasses.replace(
        cfg, mesh=1, resume=os.path.join(run_dir, "model_checkpoints",
                                         "model_0.npz")),
        str(tmp_path) + "/")])[0][1]
    assert len(resumed["train_loss"]) == 1
    assert resumed["train_loss"][0] == pytest.approx(
        metrics["train_loss"][1], rel=1e-4)


def test_vmapped_sweep_over_a_mesh_is_the_unsharded_sweep(tmp_path,
                                                          monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("EMT_FORCE_CPU", "1")
    flags = ["--seeds", "42,7", "--vmap_seeds", "--num_iterations", "2",
             "--fuse", "2", "--meta_batch_size", "2", "--adapt_batch_size",
             "2", "--max_path_length", "5", "--n_eval_tasks", "1",
             "--compile_cache", "off"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain = tsweep.main(["maml_ppo", *flags, "--sweep_dir", "plain"])
    finally:
        torch.set_num_threads(threads)
    meshed = tsweep.main(["maml_ppo", *flags, "--mesh", "2",
                          "--sweep_dir", "meshed"])
    assert [r["seed"] for r in meshed["runs"]] == [42, 7]
    for a, b in zip(meshed["runs"], plain["runs"]):
        assert a["eval_reward"] == b["eval_reward"]
        for name in ("metrics.json",):
            with open(os.path.join(a["run_dir"], name)) as fa, \
                    open(os.path.join(b["run_dir"], name)) as fb:
                assert json.load(fa) == json.load(fb)
        ma, mb = _model(a["run_dir"]), _model(b["run_dir"])
        assert all(np.array_equal(ma[k], mb[k]) for k in ma)
