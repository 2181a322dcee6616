"""The port's CUDA kernels vs their plain twins, on the card.

Needs an NVIDIA Hopper card; skips without one. This file imports
neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from exploring_meta_tpu_torch.cuda import cnn4_cuda as tc
from exploring_meta_tpu_torch.models.cnn4 import init_cnn4, omniglot_spec
from exploring_meta_tpu_torch.models.layers import set_precision
from exploring_meta_tpu_torch.serve import VisionServer


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    set_precision("highest")
    return torch.device("cuda")


def _block_inputs(rng, dev, b, n, h, ci, co=64):
    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)
    x = t(rng.normal(size=(b, n, h, h, ci)))
    w = t(rng.normal(size=(b, 3, 3, ci, co)) * (2.0 / (9 * ci)) ** 0.5)
    p = [t(rng.normal(size=(b, co)) * 0.1),
         t(rng.uniform(0.1, 1.0, size=(b, co))),
         t(rng.normal(size=(b, co)) * 0.1)]
    # no cotangent where the ReLU input sits within 1e-3 of its kink:
    # there f32 rounding may decide the mask differently on the two sides
    xh, _, s, be = tc.bn_stats_plain(x, w, *p)
    ho = tc.out_hw(h)
    g = t(rng.normal(size=(b, n, ho, ho, co))) * ((xh * s + be).abs() > 1e-3)
    return x, w, p, g


@pytest.mark.cuda
@pytest.mark.parametrize("h,ci", [(28, 1), (14, 64), (7, 64), (4, 64)])
def test_kernels_match_plain_twins(cuda_device, h, ci):
    x, w, p, g = _block_inputs(np.random.default_rng(h), cuda_device,
                               4, 25, h, ci)
    torch.testing.assert_close(tc.block_fwd(x, w, *p),
                               tc.block_fwd_plain(x, w, *p),
                               rtol=1e-4, atol=1e-4)
    got = tc.block_bwd_params(x, w, *p, g)
    want = tc.block_bwd_params_plain(x, w, *p, g)
    for i, (a, b) in enumerate(zip(got, want)):
        if i != 2:      # db = sum(dy) is zero up to rounding on both sides
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(tc.block_bwd_input(got[0], w, h, h),
                               tc.block_bwd_input_plain(got[0], w, h, h),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_served_batch_runs_every_kernel(cuda_device):
    spec = omniglot_spec(ways=5)
    params = init_cnn4(torch.Generator().manual_seed(0), spec,
                       device=cuda_device)
    server = VisionServer(spec, params, inner_lr=0.5, adapt_steps=1)
    rng = np.random.default_rng(0)
    sx = torch.tensor(rng.normal(size=(3, 25, 28, 28, 1)),
                      dtype=torch.float32)
    sy = torch.arange(5).repeat(5).expand(3, -1)
    tc.reset_launch_counts()
    preds, probs = server.batch(sx, sy, sx[:, :15])
    torch.cuda.synchronize()
    assert tc.launch_counts() == {"cnn4_block_fwd": 8,
                                  "cnn4_block_bwd_params": 4,
                                  "cnn4_block_bwd_input": 3}
    assert torch.isfinite(probs).all() and preds.shape == (3, 15)
