"""``--resume`` of the PyTorch port on the CPU, after the JAX package's
``TestRLResume`` and ``TestResume`` (``tests/test_rl.py``,
``tests/test_maml.py``).

A checkpoint is written after its iteration and carries the params, the
Adam state and the run's generator, so a run resumed from it continues at
the next iteration and reproduces the uninterrupted run exactly: the same
later rows of ``metrics.json`` (``total - done - 1`` of them), the same
final params and the same final meta-test. JAX holds its resume at 1e-5;
the port's CPU path is deterministic, so it is held bit for bit. Small
size: 2 tasks, 2 episodes, 5 steps (RL); meta-batch 2, 5-way 1-shot on the
small synthetic Omniglot at full CNN4 width (vision).
"""

import os

import numpy as np
import pytest
import torch

from exploring_meta_tpu_torch.models.layers import get_conv_impl, set_conv_impl
from exploring_meta_tpu_torch.trainers.rl import RLTrainer
from exploring_meta_tpu_torch.trainers.vision import VisionTrainer
from exploring_meta_tpu_torch.utils.config import RLScriptConfig, VisionConfig

TOTAL = 4
RL = dict(env="Particles2D-v1", num_iterations=TOTAL, meta_batch_size=2,
          adapt_batch_size=2, max_path_length=5, save_every=1,
          n_eval_tasks=2, inner_lr=0.05, outer_lr=3e-3, seed=11)
VISION = dict(num_iterations=TOTAL, meta_batch_size=2, shots=1,
              save_every=1, synthetic=True, seed=5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the vision runs train the CNN4 at full width,
    which only loses to the contention of several test workers' thread
    pools."""
    threads, conv = torch.get_num_threads(), get_conv_impl()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    set_conv_impl(conv)


def _run(kind, path, **kw):
    if kind == "vision":
        trainer = VisionTrainer(VisionConfig(**{**VISION, **kw}),
                                path=str(path) + "/", device="cpu")
    else:
        trainer = RLTrainer(RLScriptConfig(**{**RL, **kw}), algo=kind,
                            path=str(path) + "/", device="cpu")
    return trainer, trainer.run()


def _model(trainer):
    with np.load(os.path.join(trainer.model_path, "model.npz")) as z:
        return {k: z[k] for k in z.files}


# (trainer kind, options, the checkpoint resumed from: its name under
# model_checkpoints/ or the directory itself, its iteration)
CASES = {
    "ppo": ("ppo", {}, "model_1.npz", 1),
    "ppo_fuse2": ("ppo", {"fuse": 2}, "model_1.npz", 1),
    "trpo": ("trpo", {"outer_lr": 0.3}, "model_1.npz", 1),
    "maml_vision": ("vision", {}, "model_1.npz", 1),
    "maml_vision_fuse2": ("vision", {"fuse": 2}, "model_1.npz", 1),
    "ppo_dcp": ("ppo", {"ckpt_backend": "orbax", "save_every": 2}, "", 2),
    "ppo_async": ("ppo", {"async_ckpt": True}, "model_2.npz", 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_resumed_run_equals_the_uninterrupted_run(tmp_path, case):
    kind, kw, ckpt, done = CASES[case]
    full, full_out = _run(kind, tmp_path / "full", **kw)
    if kw.get("fuse"):
        # fused checkpoints land on chunk ends: model_1 ends the first chunk
        assert sorted(os.listdir(os.path.join(
            full.model_path, "model_checkpoints"))) == [
                "model_1.npz", "model_3.npz"]
    resume = os.path.join(full.model_path, "model_checkpoints", ckpt)
    res, res_out = _run(kind, tmp_path / "resumed", resume=resume, **kw)
    assert res_out == full_out                      # the final meta-test
    for key, rows in res.metrics.items():
        want = full.metrics[key]
        if len(want) == TOTAL:
            assert len(rows) == TOTAL - done - 1, key
        assert rows == want[len(want) - len(rows):], key
    got, want = _model(res), _model(full)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind", ["ppo", "vision"])
def test_a_missing_resume_file_raises(tmp_path, kind):
    with pytest.raises(FileNotFoundError):
        _run(kind, tmp_path, resume=str(tmp_path / "model_7.npz"))
    (tmp_path / "model_checkpoints").mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoint steps"):
        _run(kind, tmp_path, resume=str(tmp_path / "model_checkpoints"))


def test_resume_takes_the_saved_adam_and_generator(tmp_path):
    """The resumed trainer starts from the checkpoint's Adam moments and
    count, and from the generator state saved with them."""
    full, _ = _run("ppo", tmp_path / "full", num_iterations=2)
    path = os.path.join(full.model_path, "model_checkpoints", "model_0.npz")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    assert int(flat["__opt__/0/count"]) == 1
    assert flat["__opt__/0/count"].dtype == np.int32
    assert "__rng__" not in flat and "__torch_rng__/cpu" in flat
    gen = torch.Generator()
    gen.set_state(torch.from_numpy(flat["__torch_rng__/cpu"]))
    assert gen.get_state().shape == (5056,)
