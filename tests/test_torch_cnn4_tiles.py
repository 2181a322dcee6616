"""The decompositions of the tiled CNN4 kernels, in plain PyTorch, vs JAX.

``cnn4_block_fwd`` takes BN statistics per tile of 64 positions and
combines them in tile order (Chan's formula); ``cnn4_block_bwd_input``
splits the transposed stride-2 conv into four parity classes of input
positions. Both are written out in plain PyTorch beside the kernels' twins
(``cuda/cnn4_cuda.py``) and held here, on numpy inputs from a seed, against
the two-pass statistics and the JAX package's ``_block_fwd`` and
``_conv_s2_bwd`` (``pallas/cnn4_pallas.py:116``, ``:127``). Tolerances: the
tiled statistics equal the two-pass ones within 1e-6 relative (both f32
over the same y; only the summation order differs); the forward as the
repo's Pallas tests hold it, 2e-5; dx within 1e-5 (rtol and atol).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_meta_tpu.pallas import cnn4_pallas as jp
from exploring_meta_tpu_torch.cuda import cnn4_cuda as tc

HIDDEN = 8
N = 3
B = 2
# (H, Ci) of the four Omniglot blocks at the narrow test width
BLOCKS = [(28, 1), (14, HIDDEN), (7, HIDDEN), (4, HIDDEN)]


def _inputs(seed, h, ci, wd=None):
    rng = np.random.default_rng(seed)
    wd = h if wd is None else wd
    x = rng.normal(size=(B, N, h, wd, ci)).astype(np.float32)
    w = (rng.normal(size=(B, 3, 3, ci, HIDDEN)) * 0.3).astype(np.float32)
    p = [(rng.normal(size=(B, HIDDEN)) * 0.1).astype(np.float32),
         rng.uniform(0.2, 1.0, size=(B, HIDDEN)).astype(np.float32),
         (rng.normal(size=(B, HIDDEN)) * 0.1).astype(np.float32)]
    dy = rng.normal(size=(B, N, tc.out_hw(h), tc.out_hw(wd), HIDDEN)
                    ).astype(np.float32)
    return x, w, p, dy


def _tiled_stats(y, tile):
    """(mean, var) of y [B, M, C] the way the forward's kernels take them."""
    return tc.combine_tile_stats_plain(*tc.tile_stats_plain(y, tile))


@pytest.mark.parametrize("blk", range(4))
@pytest.mark.parametrize("tile", [64, 10, 13, 1, None])
def test_tile_statistics_equal_two_pass(blk, tile):
    """Per-tile (n_t, mean_t, M2_t) combined in tile order equal the
    two-pass statistics of the same y, for tiles that split M raggedly
    (None: one tile of all M)."""
    h, ci = BLOCKS[blk]
    x, w, p, _ = _inputs(blk, h, ci)
    y = tc.conv_plain(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(p[0]))
    y = y.reshape(B, -1, HIDDEN)
    m = y.shape[1]
    if tile is not None:
        assert m % tile or tile == 1    # the last tile is ragged
    mean, var = _tiled_stats(y, tile or m)
    mu2 = y.mean(dim=1)
    var2 = (y - mu2[:, None]).square().mean(dim=1)
    scale = (mu2.square() + var2).sqrt()
    # the mean relative to the channel's scale: it may sit near zero
    assert ((mean - mu2).abs() <= 1e-6 * scale).all()
    np.testing.assert_allclose(var, var2, rtol=1e-6, atol=0)


@pytest.mark.parametrize("blk", range(4))
def test_tiled_forward_matches_jax_block_fwd(blk):
    """conv -> tile statistics (64 rows) -> combine -> normalise equals
    JAX's ``_block_fwd`` per task, output and inv_std."""
    h, ci = BLOCKS[blk]
    x, w, p, _ = _inputs(10 + blk, h, ci)
    y = tc.conv_plain(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(p[0]))
    mean, var = _tiled_stats(y.reshape(B, -1, HIDDEN), 64)
    inv = torch.rsqrt(var + tc.EPS)
    s, be = (torch.from_numpy(a)[:, None, None, None] for a in p[1:])
    a = torch.relu((y - mean[:, None, None, None]) * inv[:, None, None, None]
                   * s + be)
    for t in range(B):
        want_a, _, want_inv = jp._block_fwd(
            jnp.asarray(x[t]), jnp.asarray(w[t]),
            *(jnp.asarray(q[t]) for q in p))
        np.testing.assert_allclose(a[t], np.asarray(want_a),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(inv[t], np.asarray(want_inv).reshape(-1),
                                   rtol=2e-5, atol=0)


@pytest.mark.parametrize("h,wd", [(5, 5), (4, 4), (7, 6), (6, 9), (1, 2)])
def test_parity_classes_hold_every_tap_once(h, wd):
    """Each input position gets, through its class, exactly the taps of
    the transposed conv's definition: (ty, i) with hi = 2i + ty - 1 and i
    in [0, Ho) (out-of-range sources are the zero-filled ones); class tap
    counts are 4, 2, 2, 1."""
    ho, wo = tc.out_hw(h), tc.out_hw(wd)
    classes = tc.parity_classes()
    assert [len(taps) for _, taps in classes] == [4, 2, 2, 1]
    for (ph, pw), taps in classes:
        for hi in range(ph, h, 2):
            for wi in range(pw, wd, 2):
                a, b = hi // 2, wi // 2
                got = {(ty, tx, a + di, b + dj) for ty, tx, di, dj in taps
                       if a + di < ho and b + dj < wo}
                want = {(ty, tx, i, j) for ty in range(3) for tx in range(3)
                        for i in range(ho) for j in range(wo)
                        if 2 * i + ty - 1 == hi and 2 * j + tx - 1 == wi}
                assert got == want


@pytest.mark.parametrize("h,wd,ci", [(28, 28, 1), (14, 14, HIDDEN),
                                     (7, 7, HIDDEN), (4, 4, HIDDEN),
                                     (7, 6, 3), (6, 9, HIDDEN)])
def test_parity_gather_matches_plain_and_jax(h, wd, ci):
    """dx as four parity-class GEMMs equals the tap-scatter twin
    ``block_bwd_input_plain`` and JAX's ``_conv_s2_bwd``, for odd and
    even extents."""
    x, w, _, dy = _inputs(h * wd + ci, h, ci, wd)
    tw, tdy = torch.from_numpy(w), torch.from_numpy(dy)
    got = tc.block_bwd_input_parity_plain(tdy, tw, h, wd)
    np.testing.assert_allclose(got, tc.block_bwd_input_plain(tdy, tw, h, wd),
                               rtol=1e-5, atol=1e-5)
    for t in range(B):
        _, _, want = jp._conv_s2_bwd(jnp.asarray(x[t]), jnp.asarray(dy[t]),
                                     jnp.asarray(w[t]))
        np.testing.assert_allclose(got[t], np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_forward_workspace_floats():
    """The forward's scratch (mirrors ``launch_fwd_t``): tile and task
    statistics, plus y where the output (bf16) cannot hold it."""
    b, n, h, co = 64, 25, 14, 64
    tiles = -(-n * 7 * 7 // 64)
    stats = 2 * b * tiles * co + 2 * b * co
    assert tc.fwd_workspace_floats(b, n, h, h, co, torch.float32) == stats
    assert tc.fwd_workspace_floats(b, n, h, h, co,
                                   torch.bfloat16) == stats + b * n * 49 * co
