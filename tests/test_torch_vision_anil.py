"""ANIL vision meta-training and the Mini-ImageNet data of the PyTorch
port vs the JAX package, on the CPU.

``make_vision_fast_adapt(anil=True)`` with 1 and 2 inner steps (loss,
metric, meta-grads; its spec, hidden 32, takes the per-op path) on
identical params and task batches, both variants in one jitted JAX
program; ``remat_body`` on against off; the synthetic Mini-ImageNet bytes
and the packed-file rules of ``load_mini_imagenet`` / ``get_dataset``.
Tolerances as ``tests/test_torch_vision_meta.py`` states them.
"""

import numpy as np
import pytest
import torch

from exploring_meta_tpu import tasks as jtasks
from exploring_meta_tpu_torch.adapt.vision import make_vision_fast_adapt
from exploring_meta_tpu_torch.tasks import datasets as td
from exploring_meta_tpu_torch.utils.tree import tree_leaves

from test_torch_vision_meta import (
    LR, SPECS, WAYS, _held, _params, _port_loss_and_grads, _task_batch,
    jax_refs,
)

ANIL = {"one_step": dict(adapt_steps=1), "two_steps": dict(adapt_steps=2)}


@pytest.fixture(scope="module")
def anil_ref():
    np_params, (data, labels) = _params(True), _task_batch(2, seed=2)
    return np_params, data, labels, jax_refs(True, 2, ANIL, np_params, data,
                                             labels)


@pytest.mark.parametrize("variant", sorted(ANIL))
def test_anil_fast_adapt_matches_jax(anil_ref, variant):
    np_params, data, labels, ref = anil_ref
    got = _port_loss_and_grads(
        make_vision_fast_adapt(SPECS[True][1], LR, shots=2, ways=WAYS,
                               anil=True, **ANIL[variant]),
        np_params, data, labels)
    want = ref[variant]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert got[1] == pytest.approx(want[1], abs=1e-6)
    _held(got[2], want[2])


def test_anil_remat_body_equals_plain():
    np_params, (data, labels) = _params(True), _task_batch(1, seed=3)
    out = [_port_loss_and_grads(
        make_vision_fast_adapt(SPECS[True][1], LR, 1, 1, WAYS, anil=True,
                               remat_body=remat), np_params, data, labels)
        for remat in (False, True)]
    assert out[0][:2] == out[1][:2]
    for a, b in zip(tree_leaves(out[0][2]), tree_leaves(out[1][2])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_mini_imagenet_synthetic_bytes_match_jax():
    got = td.load_mini_imagenet(seed=3, synthetic=True, synthetic_per_class=2,
                                device="cpu")
    want = jtasks.load_mini_imagenet(seed=3, synthetic=True,
                                     synthetic_per_class=2)
    for g, w in zip(got, want):
        assert (g.name, g.invert, g.rotations) == (w.name, w.invert,
                                                   w.rotations)
        np.testing.assert_array_equal(g.images.numpy(), np.asarray(w.images))
    assert [g.n_classes for g in got] == [64, 16, 20]
    via = td.get_dataset("mini_imagenet", seed=3, synthetic=True,
                         synth_per_class=2, device="cpu")
    assert all(torch.equal(a.images, b.images) for a, b in zip(via, got))
    with pytest.raises(ValueError, match="fixed"):
        td.get_dataset("min", synth_classes=10, device="cpu")
    with pytest.raises(ValueError, match="unknown dataset"):
        td.get_dataset("cifar", device="cpu")


def test_packed_files_partial_or_missing_raise(tmp_path, monkeypatch):
    monkeypatch.setattr(td, "DATA_DIR", str(tmp_path))
    np.savez(tmp_path / "mini_imagenet_train.npz",
             images=np.zeros((64, 1, 84, 84, 3), np.uint8))
    with pytest.raises(ValueError, match="partially packed"):
        td.load_mini_imagenet(device="cpu")
    with pytest.raises(FileNotFoundError):
        td.load_omniglot(synthetic=False, device="cpu")
