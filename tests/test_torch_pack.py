"""Dataset packing of the PyTorch port (``tasks/pack.py``, the CLI's
``pack_datasets``) against the JAX package's, after
``tests/test_pack_datasets.py``: a tiny generated Omniglot PNG tree and
Mini-ImageNet cache pickles (no download). The port's packed arrays equal
JAX's byte for byte, and the port's ``tasks/datasets.py`` reads them with
the reference's splits (Omniglot 1100 / 100 / 423 shuffled classes).
"""

import os
import pickle
import sys

import numpy as np
import pytest

from exploring_meta_tpu.tasks import datasets as jds
from exploring_meta_tpu.tasks import pack as jpack
from exploring_meta_tpu_torch import cli
from exploring_meta_tpu_torch.tasks import datasets as tds
from exploring_meta_tpu_torch.tasks import pack as tpack
from test_pack_datasets import _write_omniglot_tree


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_pack_omniglot_equals_jax_and_lanczos(tmp_path):
    from PIL import Image

    src = str(tmp_path / "src")
    truths = _write_omniglot_tree(src)
    tpack.pack_omniglot(src, str(tmp_path / "port"))
    jpack.pack_omniglot(src, str(tmp_path / "jax"))
    ours = _load(tmp_path / "port" / "omniglot.npz")
    theirs = _load(tmp_path / "jax" / "omniglot.npz")
    assert ours.keys() == theirs.keys() == {"images"}
    np.testing.assert_array_equal(ours["images"], theirs["images"])
    images = ours["images"]
    assert images.shape == (6, 20, 28, 28, 1) and images.dtype == np.uint8
    # raw LANCZOS, no invert: class 0 is background/Alphabet0/character00
    ref = Image.fromarray(truths[("images_background", 0, 0, 0)],
                          mode="L").resize((28, 28), Image.LANCZOS)
    np.testing.assert_array_equal(images[0, 0, :, :, 0],
                                  np.asarray(ref, np.uint8))


def test_pack_omniglot_refuses_an_incomplete_class(tmp_path):
    src = str(tmp_path / "src")
    _write_omniglot_tree(src, n_alphabets=1, chars_per_alphabet=1,
                         samples=3, size=28)
    with pytest.raises(SystemExit, match="incomplete"):
        tpack.pack_omniglot(src, str(tmp_path / "out"))
    with pytest.raises(SystemExit, match="no Omniglot class"):
        tpack.pack_omniglot(str(tmp_path / "empty"), str(tmp_path / "out"))


def _mini_imagenet_pickles(src):
    os.makedirs(src)
    rng = np.random.default_rng(1)
    sizes = {"train": 4, "validation": 3, "test": 2}
    for mode, n_cls in sizes.items():
        n_per = 12 - n_cls          # classes of unequal size: min is kept
        img = (rng.random((n_cls * 12, 84, 84, 3)) * 255).astype(np.uint8)
        class_dict = {f"n{mode}{c:02d}": list(range(c * 12, c * 12 + n_per
                                                    + c))
                      for c in range(n_cls)}
        stem = "val" if mode == "validation" else mode
        with open(os.path.join(src, f"mini-imagenet-cache-{stem}.pkl"),
                  "wb") as f:
            pickle.dump({"image_data": img, "class_dict": class_dict}, f)
    return sizes


def test_pack_mini_imagenet_equals_jax(tmp_path):
    src = str(tmp_path / "src")
    sizes = _mini_imagenet_pickles(src)
    tpack.pack_mini_imagenet(src, str(tmp_path / "port"))
    jpack.pack_mini_imagenet(src, str(tmp_path / "jax"))
    for mode, n_cls in sizes.items():
        name = f"mini_imagenet_{mode}.npz"
        ours = _load(tmp_path / "port" / name)["images"]
        np.testing.assert_array_equal(
            ours, _load(tmp_path / "jax" / name)["images"])
        assert ours.shape == (n_cls, 12 - n_cls, 84, 84, 3)
        assert ours.dtype == np.uint8
    with pytest.raises(SystemExit, match="missing mini-imagenet pickle"):
        tpack.pack_mini_imagenet(str(tmp_path / "port"),
                                 str(tmp_path / "out"))


def test_cli_pack_datasets_and_the_split_1100_100_423(tmp_path, monkeypatch):
    """``pack_datasets omniglot`` from argv on a tree of the real class
    count's shape (1623 classes, small images copied from one class), and
    the port's loader splits it as JAX's does: 1100 / 100 / 423 shuffled
    classes, the same classes on both sides, invert and rotations on."""
    src = str(tmp_path / "src")
    _write_omniglot_tree(src, n_alphabets=1, chars_per_alphabet=1, size=28)
    one = os.path.join(src, "images_background", "Alphabet0", "character00")
    base = os.path.join(src, "images_background", "Alphabet1")
    for c in range(1623 - 2):
        os.makedirs(os.path.join(base, f"character{c:04d}"))
        for f in sorted(os.listdir(one)):
            os.link(os.path.join(one, f),
                    os.path.join(base, f"character{c:04d}", f))
    out = str(tmp_path / "packed")
    cli.pack_datasets(["omniglot", "--src", src, "--out", out])
    packed = _load(os.path.join(out, "omniglot.npz"))["images"]
    assert packed.shape == (1623, 20, 28, 28, 1)
    # stamp each class's id so the splits can be told apart
    packed[:, :, 0, 0, 0] = (np.arange(1623) % 251)[:, None]
    np.savez(os.path.join(out, "omniglot.npz"), images=packed)
    monkeypatch.setattr(tds, "DATA_DIR", out)
    monkeypatch.setattr(jds, "DATA_DIR", out)
    ours = tds.load_omniglot(seed=42, synthetic=False, device="cpu")
    theirs = jds.load_omniglot(seed=42, synthetic=False)
    assert [s.n_classes for s in ours] == [1100, 100, 423]
    for o, t in zip(ours, theirs):
        np.testing.assert_array_equal(o.images.numpy(), np.asarray(t.images))
        assert o.invert and o.rotations


def test_cli_pack_mini_imagenet_is_read_by_the_port(tmp_path, monkeypatch):
    src = str(tmp_path / "src")
    sizes = _mini_imagenet_pickles(src)
    out = str(tmp_path / "packed")
    cli.pack_datasets(["mini-imagenet", "--src", src, "--out", out])
    monkeypatch.setattr(tds, "DATA_DIR", out)
    train, valid, test = tds.load_mini_imagenet(synthetic=False,
                                                device="cpu")
    assert [s.n_classes for s in (train, valid, test)] == list(
        sizes.values())
    assert not train.invert and not train.rotations


def test_pack_imports_pillow_inside_the_function():
    assert "PIL" not in vars(tpack)
    assert "exploring_meta_tpu_torch.tasks.pack" in sys.modules
