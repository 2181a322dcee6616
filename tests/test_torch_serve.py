"""VisionServer of the PyTorch port vs ``exploring_meta_tpu.serve``.

Both servers get the same params (bridged from JAX) and the same numpy
requests. The port runs on the CPU, where its Omniglot base takes the
fused block's plain twins; the JAX server runs its default XLA path.
Probabilities agree to 1e-4; predicted labels agree wherever the top-2
margin exceeds 1e-3 (a nearer tie may flip on f32 rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_meta_tpu.models import cnn4 as jc
from exploring_meta_tpu.serve import VisionServer as JaxServer
from exploring_meta_tpu.utils.experiment import flatten_params as jax_flatten
from exploring_meta_tpu_torch.cuda import cnn4_cuda
from exploring_meta_tpu_torch.models import cnn4 as tcnn
from exploring_meta_tpu_torch.serve import VisionServer
from exploring_meta_tpu_torch.utils.bridge import params_from_jax

WAYS, SHOTS, Q = 5, 2, 6


def _requests(seed, b, shots=SHOTS):
    rng = np.random.default_rng(seed)
    sx = rng.normal(size=(b, shots * WAYS, 28, 28, 1)).astype(np.float32)
    sy = np.tile(np.tile(np.arange(WAYS), shots), (b, 1)).astype(np.int32)
    qx = rng.normal(size=(b, Q, 28, 28, 1)).astype(np.float32)
    return sx, sy, qx


def _check_against_jax(got, want):
    preds, probs = (t.numpy() for t in got)
    jpreds, jprobs = (np.asarray(a) for a in want)
    np.testing.assert_allclose(probs, jprobs, rtol=1e-4, atol=1e-4)
    top2 = np.sort(jprobs, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-3
    np.testing.assert_array_equal(preds[clear], jpreds[clear])


@pytest.mark.parametrize("anil", [False, True])
def test_matches_jax_server(anil):
    if anil:
        jspec, tspec = jc.anil_omniglot_spec(WAYS), tcnn.anil_omniglot_spec(WAYS)
    else:
        jspec = jc.omniglot_spec(WAYS, hidden=16)
        tspec = tcnn.omniglot_spec(WAYS, hidden=16)
    jparams = jc.init_cnn4(jax.random.key(0), jspec)
    kw = dict(inner_lr=0.5, adapt_steps=2, anil=anil)
    jserver = JaxServer(jspec, jparams, **kw)
    tserver = VisionServer(tspec, params_from_jax(jparams, "cpu"),
                           device="cpu", **kw)
    sx, sy, qx = _requests(1, 3)
    _check_against_jax(tserver.batch(sx, sy, qx),
                       jserver.batch(jnp.asarray(sx), jnp.asarray(sy),
                                     jnp.asarray(qx)))
    _check_against_jax(tserver(sx[0], sy[0], qx[0]),
                       jserver(jnp.asarray(sx[0]), jnp.asarray(sy[0]),
                               jnp.asarray(qx[0])))


def test_batch_equals_loop_and_learns_support():
    spec = tcnn.omniglot_spec(WAYS, hidden=16)
    params = tcnn.init_cnn4(torch.Generator().manual_seed(0), spec,
                            device="cpu")
    server = VisionServer(spec, params, inner_lr=0.5, adapt_steps=2,
                          device="cpu")
    sx, sy, qx = _requests(2, 3)
    bpreds, bprobs = server.batch(sx, sy, qx)
    assert bpreds.shape == (3, Q) and bprobs.shape == (3, Q, WAYS)
    torch.testing.assert_close(bprobs.sum(-1), torch.ones(3, Q))
    for i in range(3):
        preds, probs = server(sx[i], sy[i], qx[i])
        torch.testing.assert_close(preds, bpreds[i], rtol=0, atol=0)
        torch.testing.assert_close(probs, bprobs[i], rtol=1e-5, atol=1e-5)
    # after inner SGD on the support set, it labels that set above chance
    sx, sy, _ = _requests(3, 2, shots=4)
    preds, _ = server.batch(sx, sy, sx)
    assert float((preds.numpy() == sy).mean()) > 0.5


def test_bf16_compute_returns_f32_probs():
    spec = tcnn.omniglot_spec(WAYS, hidden=8)
    params = tcnn.init_cnn4(torch.Generator().manual_seed(1), spec,
                            device="cpu")
    server = VisionServer(spec, params, inner_lr=0.5, adapt_steps=1,
                          compute_dtype=torch.bfloat16, device="cpu")
    sx, sy, qx = _requests(4, 2)
    preds, probs = server.batch(sx, sy, qx)
    assert probs.dtype == torch.float32 and preds.shape == (2, Q)
    assert torch.isfinite(probs).all()


def test_from_checkpoint_loads_jax_npz(tmp_path):
    jspec = jc.omniglot_spec(WAYS, hidden=8)
    jparams = jc.init_cnn4(jax.random.key(3), jspec)
    path = str(tmp_path / "model.npz")
    np.savez(path, **jax_flatten(jparams))
    tspec = tcnn.omniglot_spec(WAYS, hidden=8)
    loaded = VisionServer.from_checkpoint(path, tspec, inner_lr=0.5,
                                          adapt_steps=1, device="cpu")
    direct = VisionServer(tspec, params_from_jax(jparams, "cpu"),
                          inner_lr=0.5, adapt_steps=1, device="cpu")
    sx, sy, qx = _requests(5, 2)
    a, b = loaded.batch(sx, sy, qx), direct.batch(sx, sy, qx)
    torch.testing.assert_close(a[1], b[1], rtol=0, atol=0)


def test_default_device_is_the_card_never_the_cpu():
    spec = tcnn.omniglot_spec(WAYS, hidden=8)
    params = tcnn.init_cnn4(torch.Generator().manual_seed(0), spec,
                            device="cpu")
    if torch.cuda.is_available():
        server = VisionServer(spec, params, inner_lr=0.5, adapt_steps=1)
        assert server.device.type == "cuda"
        assert all(t.is_cuda for t in server.params["head"].values())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            VisionServer(spec, params, inner_lr=0.5, adapt_steps=1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcnn.init_cnn4(torch.Generator(), spec)


def test_cpu_serving_launches_no_kernel():
    spec = tcnn.omniglot_spec(WAYS, hidden=8)
    params = tcnn.init_cnn4(torch.Generator().manual_seed(0), spec,
                            device="cpu")
    server = VisionServer(spec, params, inner_lr=0.5, adapt_steps=1,
                          device="cpu")
    cnn4_cuda.reset_launch_counts()
    server.batch(*_requests(6, 1))
    assert set(cnn4_cuda.launch_counts().values()) == {0}
