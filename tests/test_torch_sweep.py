"""The port's sweep command (``exploring_meta_tpu_torch/sweep.py``,
``cli.py:sweep``) end to end on the CPU, against ``scripts/sweep.py``.

- Serial: each seed's rows, final params and final metric equal a
  standalone trainer run with that seed, bit for bit (maml_trpo), and the
  summary has JAX's keys (maml_vision ``--synthetic``).
- ``--vmap_seeds``: each seed's rows, final params and final metric equal
  the solo trainer run of that seed at the same ``--fuse`` (maml_trpo,
  chunked 2 + 1, and maml_vision, one chunk), bit for bit on the CPU; the
  per-seed run dirs hold what JAX's ``_seed_run_dirs`` writes for the
  same numbers; ``model.npz`` loads into the port and through JAX's
  ``unflatten_into``, and the run dirs load in ``eval_vision`` /
  ``eval_rl`` and the servers' ``from_checkpoint``; the band numbers
  equal JAX's ``plot_runs_with_confidence`` on the same run dirs to 1e-12.
- Every refusal: ``--resume`` / ``--profile`` / ``--trace`` under
  ``--vmap_seeds``, a host env, a ``--mesh 2`` the seeds or the
  meta-batch cannot share, an unknown algo, no seeds.

Tiny: meta-batch 2, 2 episodes of 6 steps; vision 2-3 iterations.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "scripts"))
import sweep as jsweep  # noqa: E402  (scripts/sweep.py, the reference)

from exploring_meta_tpu.models import cnn4 as jcnn  # noqa: E402
from exploring_meta_tpu.utils import plotter as jplot  # noqa: E402
from exploring_meta_tpu.utils.experiment import (  # noqa: E402
    unflatten_into as jax_unflatten_into,
)
from exploring_meta_tpu_torch import cli  # noqa: E402
from exploring_meta_tpu_torch import sweep as tsweep  # noqa: E402
from exploring_meta_tpu_torch.models.cnn4 import (  # noqa: E402
    init_cnn4, omniglot_spec,
)
from exploring_meta_tpu_torch.models.policies import (  # noqa: E402
    DiagNormalPolicy,
)
from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig  # noqa: E402
from exploring_meta_tpu_torch.serve import (  # noqa: E402
    PolicyServer, VisionServer,
)
from exploring_meta_tpu_torch.trainers.rl import RLTrainer  # noqa: E402
from exploring_meta_tpu_torch.trainers.vision import (  # noqa: E402
    VisionTrainer,
)
from exploring_meta_tpu_torch.utils.config import (  # noqa: E402
    RLScriptConfig, VisionConfig,
)
from exploring_meta_tpu_torch.utils.experiment import (  # noqa: E402
    load_params,
)

RL_FLAGS = ["--meta_batch_size", "2", "--adapt_batch_size", "2",
            "--max_path_length", "6", "--n_eval_tasks", "2",
            "--compile_cache", "off"]
RL_CFG = dict(meta_batch_size=2, adapt_batch_size=2, max_path_length=6,
              n_eval_tasks=2, compile_cache="off")
VISION_FLAGS = ["--synthetic", "--meta_batch_size", "2",
                "--compile_cache", "off"]
SUMMARY_KEYS = {"algo", "metric", "seeds", "runs", "mean", "std",
                "vmapped", "config", "band_metric", "band_final_mean"}
BAND_TOL = 1e-12


@pytest.fixture(autouse=True)
def _cpu_and_one_thread(monkeypatch):
    """The CLI on the CPU (``EMT_FORCE_CPU=1``), one intra-op thread: the
    seeded and solo runs then reduce in the same order."""
    monkeypatch.setenv("EMT_FORCE_CPU", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _read(run_dir):
    with open(os.path.join(run_dir, "metrics.json")) as f:
        metrics = json.load(f)
    with np.load(os.path.join(run_dir, "model.npz")) as z:
        model = {k: z[k] for k in z.files}
    return metrics, model


def _assert_same_run(got_dir, want_dir, final_key):
    (gm, gz), (wm, wz) = _read(got_dir), _read(want_dir)
    # a trainer's run dir also logs eval_success and the like: the sweep's
    # rows are the trainer's rows under the same names
    assert gm[final_key] == wm[final_key]
    for k, v in gm.items():
        assert v == wm[k], k
    assert gz.keys() == wz.keys()
    for k in gz:
        np.testing.assert_array_equal(gz[k], wz[k], err_msg=k)


def _solo(tmp_path, kind, seed, **cfg):
    path = str(tmp_path / f"solo{seed}") + "/"
    if kind == "rl":
        trainer = RLTrainer(RLScriptConfig(seed=seed, **RL_CFG, **cfg),
                            algo="trpo", path=path, device="cpu")
    else:
        trainer = VisionTrainer(VisionConfig(seed=seed, synthetic=True,
                                             meta_batch_size=2,
                                             compile_cache="off", **cfg),
                                path=path, device="cpu")
    trainer.run()
    return trainer.model_path


def _summary(tmp_path, tag):
    with open(tmp_path / "sweeps" / f"{tag}.json") as f:
        return json.load(f)


def test_serial_trpo_sweep_equals_solo_trainer_runs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cli.COMMANDS["sweep"](["maml_trpo", "--seeds", "42,7",
                           "--num_iterations", "2", *RL_FLAGS])
    s = _summary(tmp_path, "maml_trpo_42-7")
    assert set(s) == SUMMARY_KEYS and s["vmapped"] is False
    assert s["metric"] == "eval_reward" and s["band_metric"] == "adapt_reward"
    for run in s["runs"]:
        _assert_same_run(run["run_dir"], _solo(tmp_path, "rl", run["seed"],
                                                num_iterations=2),
                         "eval_reward")
    assert np.isfinite(s["band_final_mean"])
    assert (tmp_path / "sweeps" / "maml_trpo_42-7.png").exists()


def test_serial_vision_sweep_writes_jax_summary(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    s = tsweep.main(["maml_vision", "--seeds", "42,7", "--num_iterations",
                     "2", "--save_every", "10", *VISION_FLAGS])
    assert s == _summary(tmp_path, "maml_vision_42-7")
    assert set(s) == SUMMARY_KEYS and s["vmapped"] is False
    assert [r["seed"] for r in s["runs"]] == [42, 7]
    assert s["metric"] == "test_acc" and s["band_metric"] == "valid_acc"
    for run in s["runs"]:
        assert {"metrics.json", "logger.json", "model.npz"} <= set(
            os.listdir(run["run_dir"]))
    assert s["config"] == VisionConfig(
        num_iterations=2, save_every=10, synthetic=True, meta_batch_size=2,
        compile_cache="off").to_params()


def _jax_run_dirs(tmp_path, algo, s, final_key, trainer_algo, dataset,
                  base_cfg):
    """JAX's ``_seed_run_dirs`` on the port's numbers: the metrics and the
    final params the port wrote for each seed."""
    per_seed = [_read(r["run_dir"]) for r in s["runs"]]
    metrics = {k: np.stack([m[k] for m, _ in per_seed])
               for k in per_seed[0][0] if k != final_key}
    params = {k: np.stack([z[k] for _, z in per_seed]) for k in per_seed[0][1]}
    return jsweep._seed_run_dirs(
        str(tmp_path / "jax"), algo, s["seeds"], metrics, params,
        [r[final_key] for r in s["runs"]], final_key, trainer_algo, dataset,
        base_cfg)


def _assert_jax_contract(port_runs, jax_runs):
    for p, j in zip(port_runs, jax_runs):
        assert sorted(os.listdir(p["run_dir"])) == sorted(
            os.listdir(j["run_dir"])) == ["logger.json", "metrics.json",
                                          "model.npz"]
        for name in ("metrics.json", "logger.json"):
            with open(os.path.join(p["run_dir"], name)) as f:
                got = json.load(f)
            with open(os.path.join(j["run_dir"], name)) as f:
                assert got == json.load(f), name
        (_, gz), (_, jz) = _read(p["run_dir"]), _read(j["run_dir"])
        assert gz.keys() == jz.keys()
        for k in gz:
            np.testing.assert_array_equal(gz[k], jz[k])


def test_vmapped_vision_sweep_rows_run_dirs_and_band(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    s = tsweep.main(["maml_vision", "--seeds", "42,7", "--vmap_seeds",
                     "--num_iterations", "2", "--seed", "42",
                     *VISION_FLAGS])
    assert set(s) == SUMMARY_KEYS and s["vmapped"] is True
    runs = s["runs"]
    with open(os.path.join(runs[0]["run_dir"], "logger.json")) as f:
        logger = json.load(f)
    assert logger["vmapped_sweep"] is True
    assert logger["config"]["algo"] == "maml_5w1s"
    # seed 42 shares the dataset its solo run samples (the base --seed):
    # the rows of a solo run of 42 at one chunk of 2 iterations
    solo = _solo(tmp_path, "vision", 42, num_iterations=2, fuse=2)
    _assert_same_run(runs[0]["run_dir"], solo, "test_acc")

    cfg = VisionConfig(**{**s["config"]})
    _assert_jax_contract(runs, _jax_run_dirs(
        tmp_path, "maml_vision", s, "test_acc", "maml_5w1s", "omni", cfg))

    band = jplot.plot_runs_with_confidence([r["run_dir"] for r in runs],
                                           metric="valid_acc")
    assert abs(s["band_final_mean"] - band["mean"][-1]) <= BAND_TOL

    model = os.path.join(runs[1]["run_dir"], "model.npz")
    template = init_cnn4(torch.Generator(), omniglot_spec(5), device="cpu")
    load_params(model, template)
    with np.load(model) as z:
        jax_unflatten_into(jcnn.init_cnn4(jax.random.key(0),
                                          jcnn.omniglot_spec(5)),
                           {k: z[k] for k in z.files})
    from exploring_meta_tpu_torch.analysis import eval_vision
    out = eval_vision.run(runs[1]["run_dir"], n_eval_batches=1, run_cl=False,
                          run_rc=False, synthetic=True, device="cpu")
    assert np.isfinite(out["test_acc"])
    server = VisionServer.from_checkpoint(model, omniglot_spec(5),
                                          inner_lr=0.5, adapt_steps=1,
                                          device="cpu")
    assert server is not None


def test_vmapped_trpo_sweep_chunks_equal_solo_fused_runs(tmp_path,
                                                         monkeypatch):
    monkeypatch.chdir(tmp_path)
    # --fuse 2 over 3 iterations: a chunk of 2 and a remainder of 1
    s = tsweep.main(["maml_trpo", "--seeds", "42,7", "--vmap_seeds",
                     "--num_iterations", "3", "--fuse", "2", *RL_FLAGS])
    assert set(s) == SUMMARY_KEYS and s["vmapped"] is True
    for run in s["runs"]:
        _assert_same_run(run["run_dir"], _solo(tmp_path, "rl", run["seed"],
                                                num_iterations=3, fuse=2),
                         "eval_reward")
    cfg = RLScriptConfig(**s["config"])
    _assert_jax_contract(s["runs"], _jax_run_dirs(
        tmp_path, "maml_trpo", s, "eval_reward", "maml_trpo",
        "Particles2D-v1", cfg))
    band = jplot.plot_runs_with_confidence(
        [r["run_dir"] for r in s["runs"]], metric="adapt_reward")
    assert abs(s["band_final_mean"] - band["mean"][-1]) <= BAND_TOL

    from exploring_meta_tpu_torch.analysis import eval_rl
    run = s["runs"][0]["run_dir"]
    out = eval_rl.run(run, device="cpu")
    assert np.isfinite(out["eval"]["mean_reward"])
    server = PolicyServer.from_checkpoint(
        os.path.join(run, "model.npz"), DiagNormalPolicy(2, 2),
        RLConfig(adapt_batch_size=2, max_path_length=6), device="cpu")
    assert server is not None


@pytest.mark.parametrize("algo", ["ppo", "vpg"])
def test_vmapped_adam_sweep_rows_are_solo_rows(tmp_path, monkeypatch, algo):
    monkeypatch.chdir(tmp_path)
    s = tsweep.main([f"anil_{algo}", "--seeds", "3,4", "--vmap_seeds",
                     "--num_iterations", "2", "--outer_lr", "0.01",
                     *RL_FLAGS])
    assert s["vmapped"] is True
    for run in s["runs"]:
        path = str(tmp_path / f"solo{run['seed']}") + "/"
        trainer = RLTrainer(RLScriptConfig(seed=run["seed"], outer_lr=0.01,
                                           num_iterations=2, fuse=2,
                                           **RL_CFG),
                            algo=algo, anil=True, path=path, device="cpu")
        trainer.run()
        _assert_same_run(run["run_dir"], trainer.model_path, "eval_reward")


@pytest.mark.parametrize("fuse,total", [(1, 5), (2, 5), (5, 5), (3, 7),
                                        (10, 3)])
def test_chunk_sizes_are_jax_chunk_sizes(fuse, total):
    cfg = RLScriptConfig(fuse=fuse, num_iterations=total)
    assert tsweep._chunk_sizes(cfg) == jsweep._chunk_sizes(cfg)
    with pytest.raises(SystemExit, match="num_iterations"):
        tsweep._chunk_sizes(RLScriptConfig(num_iterations=0))


@pytest.mark.parametrize("flag", ["resume", "profile", "trace"])
def test_vmapped_refuses_serial_only_flags(tmp_path, flag):
    value = True if flag == "profile" else "x"
    cfg = VisionConfig(**{flag: value})
    with pytest.raises(SystemExit, match=f"cannot honor --{flag}"):
        tsweep.run_vmapped("maml_vision", cfg, [0, 1], str(tmp_path),
                           "test_acc", device="cpu")


def test_refusals_host_env_mesh_unknown_algo_no_seeds(tmp_path,
                                                      monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="not a device env"):
        tsweep._vmapped_rl(RLScriptConfig(env="AntDirection-v5"), "vpg",
                           False, [0], "cpu")
    # --mesh runs (test_torch_mesh.py); what the ranks cannot share raises
    # before any rank starts
    with pytest.raises(ValueError, match="cannot shard evenly"):
        tsweep.main(["maml_vpg", "--seeds", "1,2,3", "--vmap_seeds",
                     "--mesh", "2", *RL_FLAGS])
    with pytest.raises(ValueError, match="not divisible by mesh size"):
        tsweep.main(["maml_vpg", "--seeds", "1,2", "--mesh", "2",
                     *RL_FLAGS, "--meta_batch_size", "3"])
    with pytest.raises(SystemExit, match="unknown algo"):
        tsweep.main(["nope"])
    with pytest.raises(SystemExit, match="usage"):
        tsweep.main([])
    with pytest.raises(SystemExit, match="no seeds"):
        tsweep.main(["maml_vpg", "--seeds", ","])
    assert not (tmp_path / "sweeps").exists()
