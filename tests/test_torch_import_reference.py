"""The reference-checkpoint importer of the PyTorch port
(``utils/import_torch.py``) against the JAX package's.

The state dicts come from live torch modules built to the reference's
definitions (the ``Ref*`` modules of ``tests/test_import_reference.py``),
seeded. Every layout translation is a copy or a permutation, so the
port's ``import_*`` must equal JAX's bit for bit. A whole reference run dir
imported by the port loads in JAX's ``load_params`` and in the port's
servers, and the port's ``VisionServer`` on the imported params agrees
with JAX's within ``tests/test_torch_serve.py``'s tolerance.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_meta_tpu import models as jmodels
from exploring_meta_tpu.serve import VisionServer as JaxServer
from exploring_meta_tpu.utils import import_torch as jimp
from exploring_meta_tpu.utils.experiment import flatten_params as jflatten
from exploring_meta_tpu.utils.experiment import load_params as jload_params
from exploring_meta_tpu_torch import cli
from exploring_meta_tpu_torch.models import cnn4 as tcnn
from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig
from exploring_meta_tpu_torch.serve import PolicyServer, VisionServer
from exploring_meta_tpu_torch.utils import import_torch as timp
from exploring_meta_tpu_torch.utils.tree import tree_items
from test_import_reference import (
    WAYS, RefDiagNormalPolicy, RefMiniImagenetCNN, RefOmniglotCNN,
    ref_conv_base,
)
from test_torch_serve import _check_against_jax, _requests


def _sd(module, prefix=""):
    return {prefix + k: v.detach().clone()
            for k, v in module.state_dict().items()}


def _np_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _bit_equal(port, jax_params):
    want = jflatten(jax_params)
    got = dict(tree_items(port))
    assert set(got) == set(want)
    for k, v in got.items():
        assert isinstance(v, torch.Tensor) and v.is_contiguous(), k
        assert v.dtype == torch.float32, k
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_maml_omniglot_equals_jax():
    torch.manual_seed(0)
    sd = _sd(RefOmniglotCNN())
    _bit_equal(timp.import_cnn4(sd, tcnn.omniglot_spec(WAYS)),
               jimp.import_cnn4(_np_sd(sd), jmodels.omniglot_spec(WAYS)))


def test_mini_imagenet_flatten_order_equals_jax():
    torch.manual_seed(1)
    sd = _sd(RefMiniImagenetCNN(), prefix="module.")     # MAML-wrapped
    got = timp.import_cnn4(sd, tcnn.mini_imagenet_spec(WAYS))
    _bit_equal(got, jimp.import_cnn4(_np_sd(sd),
                                     jmodels.mini_imagenet_spec(WAYS)))
    assert tuple(got["head"]["w"].shape) == (800, WAYS)


def test_anil_vision_equals_jax():
    torch.manual_seed(2)
    features = torch.nn.Sequential(ref_conv_base(1, 32, max_pool=False))
    head = torch.nn.Linear(128, WAYS)
    fsd, hsd = _sd(features), _sd(head, prefix="module.")
    _bit_equal(timp.import_anil_vision(fsd, hsd,
                                       tcnn.anil_omniglot_spec(WAYS)),
               jimp.import_anil_vision(_np_sd(fsd), _np_sd(hsd),
                                       jmodels.anil_omniglot_spec(WAYS)))


def test_diag_policy_equals_jax():
    torch.manual_seed(3)
    sd = _sd(RefDiagNormalPolicy())
    _bit_equal(timp.import_diag_policy(sd),
               jimp.import_diag_policy(_np_sd(sd)))


def test_anil_policy_sigma_reset_equals_jax():
    torch.manual_seed(4)
    body = torch.nn.Sequential(
        torch.nn.Linear(9, 100), torch.nn.Tanh(),
        torch.nn.Linear(100, 100), torch.nn.Tanh())
    head = torch.nn.Linear(100, 4)
    got = timp.import_anil_policy(_sd(body), _sd(head))
    _bit_equal(got, jimp.import_anil_policy(_np_sd(_sd(body)),
                                            _np_sd(_sd(head))))
    assert torch.equal(got["sigma"], torch.zeros(4))


def test_strip_and_detect_kind_match_jax():
    sd = {"module.a": torch.ones(1), "module.b": torch.ones(1)}
    assert set(timp.strip_maml_prefix(sd)) == {"a", "b"}
    assert timp.strip_maml_prefix({"a": 1, "module.b": 2}) == {"a": 1,
                                                               "module.b": 2}
    for cfg in ({"algo": "maml_5w1s", "dataset": "omni"},
                {"algo": "anil_5w1s", "ways": 5}, {"algo": "anil_trpo"},
                {"algo": "maml_trpo", "env": "Particles2D-v1"}):
        assert timp._detect_kind(cfg, "/nonexistent") == jimp._detect_kind(
            cfg, "/nonexistent")


def _reference_run(tmp_path, kind):
    """A reference-layout run dir of ``kind`` -> (its path, the module(s)
    whose state dicts it holds)."""
    src = tmp_path / f"{kind}_ref"
    (src / "model_checkpoints").mkdir(parents=True)
    ck = src / "model_checkpoints"
    if kind == "maml_vision":
        m = RefOmniglotCNN()
        torch.save(m.state_dict(), src / "model.pt")
        torch.save(m.state_dict(), ck / "model_100.pt")
        config = {"algo": "maml_5w1s", "dataset": "omni", "ways": WAYS,
                  "shots": 1, "seed": 42}
    elif kind == "maml_rl":
        m = RefDiagNormalPolicy()
        torch.save(m.state_dict(), src / "model.pt")
        torch.save(m.state_dict(), ck / "model_20.pt")
        config = {"algo": "maml_trpo", "env": "Particles2D-v1", "seed": 42}
    else:                                       # anil_rl, split files
        body = torch.nn.Sequential(torch.nn.Linear(2, 100), torch.nn.Tanh(),
                                   torch.nn.Linear(100, 100),
                                   torch.nn.Tanh())
        head = torch.nn.Linear(100, 2)
        for it, path in ((None, src), (30, ck)):
            pre = "" if it is None else "model_"
            suf = "" if it is None else f"_{it}"
            torch.save(body.state_dict(), path / f"{pre}body{suf}.pt")
            torch.save(head.state_dict(), path / f"{pre}head{suf}.pt")
        m = (body, head)
        config = {"algo": "anil_trpo", "env": "Particles2D-v1", "seed": 42}
    (src / "logger.json").write_text(json.dumps(
        {"config": config, "date": "x", "model_id": "42_1"}))
    (src / "metrics.json").write_text(json.dumps({"meta_loss": [1.0]}))
    return src, m


@pytest.mark.parametrize("kind", ["maml_vision", "maml_rl", "anil_rl"])
def test_import_reference_run_writes_what_jax_writes(tmp_path, kind):
    torch.manual_seed(5)
    src, _ = _reference_run(tmp_path, kind)
    ours = timp.import_reference_run(str(src), str(tmp_path / "port"))
    theirs = jimp.import_reference_run(str(src), str(tmp_path / "jax"))
    for rel in ("model.npz", *(os.path.join("model_checkpoints", f)
                               for f in os.listdir(os.path.join(
                                   theirs, "model_checkpoints")))):
        with np.load(os.path.join(ours, rel)) as a, \
                np.load(os.path.join(theirs, rel)) as b:
            assert a.files == b.files, rel
            for k in b.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for name in ("logger.json", "metrics.json"):
        with open(os.path.join(ours, name)) as f, \
                open(os.path.join(theirs, name)) as g:
            a, b = json.load(f), json.load(g)
        if name == "logger.json":
            assert a["config"].pop("imported_from") == b["config"].pop(
                "imported_from")
        assert a == b, name


def test_imported_run_serves_in_both_packages(tmp_path):
    """The port's import loads in JAX's ``load_params`` and in the port's
    ``VisionServer.from_checkpoint``, and the two servers agree."""
    torch.manual_seed(6)
    src, m = _reference_run(tmp_path, "maml_vision")
    dst = cli.import_reference_ckpt([str(src), str(tmp_path / "imported")])
    jspec, tspec = jmodels.omniglot_spec(WAYS), tcnn.omniglot_spec(WAYS)
    jparams = jload_params(os.path.join(dst, "model.npz"),
                           jmodels.init_cnn4(jax.random.key(0), jspec))
    kw = dict(inner_lr=0.5, adapt_steps=1)
    tserver = VisionServer.from_checkpoint(os.path.join(dst, "model.npz"),
                                           tspec, device="cpu", **kw)
    jserver = JaxServer(jspec, jparams, **kw)
    sx, sy, qx = _requests(7, 2, shots=1)
    _check_against_jax(tserver.batch(sx, sy, qx),
                       jserver.batch(jnp.asarray(sx), jnp.asarray(sy),
                                     jnp.asarray(qx)))
    # the server's params are the reference module's, re-laid out
    x = torch.randn(4, 1, 28, 28)
    with torch.no_grad():
        want = m.train()(x)
    got = tcnn.cnn4_apply(tserver.params, tspec,
                          x.permute(0, 2, 3, 1).contiguous())
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_imported_policy_serves_in_the_port(tmp_path):
    torch.manual_seed(7)
    src, m = _reference_run(tmp_path, "maml_rl")
    dst = timp.import_reference_run(str(src), str(tmp_path / "imported"))
    server = PolicyServer.from_checkpoint(
        os.path.join(dst, "model_checkpoints", "model_20.npz"),
        DiagNormalPolicy(2, 2), RLConfig(), device="cpu")
    s = torch.randn(5, 2)
    with torch.no_grad():
        want = m(s)
    torch.testing.assert_close(server.act(server.params, s), want,
                               rtol=1e-5, atol=1e-5)
