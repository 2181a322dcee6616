"""Datasets and episodic sampler of the PyTorch port.

The synthetic Omniglot arrays are the same numpy code in both packages,
so they must be bit-identical. The sampler draws from a torch.Generator,
whose stream differs from JAX's, so it is checked by its invariants.
"""

import numpy as np
import pytest
import torch

from exploring_meta_tpu.tasks import datasets as jd
from exploring_meta_tpu.tasks import sampler as js
from exploring_meta_tpu_torch.tasks import datasets as td
from exploring_meta_tpu_torch.tasks import sampler as ts

WAYS, SHOTS = 5, 2


@pytest.fixture(scope="module")
def omni():
    return td.load_omniglot(seed=7, synthetic=True, synthetic_classes=40,
                            device="cpu")


def test_synthetic_omniglot_bit_identical_to_jax(omni):
    want = jd.load_omniglot(seed=7, synthetic=True, synthetic_classes=40)
    for a, b in zip(omni, want):
        assert a.images.dtype == torch.uint8
        np.testing.assert_array_equal(a.images.numpy(), np.asarray(b.images))
        assert (a.name, a.invert, a.rotations) == (b.name, b.invert,
                                                   b.rotations)
    np.testing.assert_array_equal(
        td._synthetic_classes(3, 2, 4, 6, 6, 3),
        jd._synthetic_classes(3, 2, 4, 6, 6, 3))


def test_synthetic_false_requires_a_packed_file(monkeypatch, tmp_path):
    monkeypatch.setattr(td, "DATA_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        td.load_omniglot(synthetic=False, device="cpu")


def _images_as_floats(images, invert):
    f = images.float() / 255.0
    return 1.0 - f if invert else f


def test_sampler_invariants(omni):
    train = omni[0]
    gen = torch.Generator().manual_seed(0)
    data, labels = ts.sample_task_batch(gen, train, WAYS, SHOTS, 4)
    n = WAYS * 2 * SHOTS
    assert data.shape == (4, n, 28, 28, 1) and data.dtype == torch.float32
    assert labels.shape == (4, n)
    # class-major labels
    np.testing.assert_array_equal(
        labels[0].numpy(), np.repeat(np.arange(WAYS), 2 * SHOTS))
    pool = _images_as_floats(train.images, True)            # [C, P, H, W, 1]
    for b in range(4):
        cls_seen = []
        for c in range(WAYS):
            block = data[b, c * 2 * SHOTS:(c + 1) * 2 * SHOTS]
            # find the class and rotation every sample came from
            hits = set()
            for img in block:
                found = None
                for k in range(4):
                    src = torch.rot90(img, -k, dims=(0, 1))
                    eq = (pool == src).flatten(2).all(-1).nonzero()
                    if len(eq):
                        found = (int(eq[0, 0]), int(eq[0, 1]), k)
                        break
                assert found is not None
                hits.add(found)
            # one class and one rotation per class block, samples distinct
            assert len({h[0] for h in hits}) == 1
            assert len({h[2] for h in hits}) == 1
            assert len({h[1] for h in hits}) == 2 * SHOTS
            cls_seen.append(next(iter(hits))[0])
        assert len(set(cls_seen)) == WAYS              # without replacement


def test_sampler_is_seeded(omni):
    a = ts.sample_task_batch(torch.Generator().manual_seed(5), omni[0],
                             WAYS, SHOTS, 2)
    b = ts.sample_task_batch(torch.Generator().manual_seed(5), omni[0],
                             WAYS, SHOTS, 2)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    data, labels = ts.sample_task(torch.Generator().manual_seed(6),
                                  omni[0].images, WAYS, SHOTS, True, True)
    assert data.shape == (WAYS * 2 * SHOTS, 28, 28, 1)
    with pytest.raises(ValueError):
        ts.sample_task(torch.Generator(), omni[0].images, 1000, 1, True, True)


def test_split_support_query_matches_jax():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(2, WAYS * 2 * SHOTS, 3, 3, 1)).astype(np.float32)
    labels = np.tile(np.repeat(np.arange(WAYS), 2 * SHOTS), (2, 1))
    (sx, sy), (qx, qy) = ts.split_support_query(
        torch.from_numpy(data), torch.from_numpy(labels), SHOTS, WAYS)
    for b in range(2):
        (jsx, jsy), (jqx, jqy) = js.split_support_query(data[b], labels[b],
                                                        SHOTS, WAYS)
        for got, want in ((sx, jsx), (sy, jsy), (qx, jqx), (qy, jqy)):
            np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
    # each class contributes `shots` support and `shots` query samples
    assert sorted(sy[0].tolist()) == sorted(qy[0].tolist()) == \
        sorted(np.repeat(np.arange(WAYS), SHOTS).tolist())
    (one_x, _), _ = ts.split_support_query(torch.from_numpy(data[0]),
                                           torch.from_numpy(labels[0]),
                                           SHOTS, WAYS)
    torch.testing.assert_close(one_x, sx[0])
