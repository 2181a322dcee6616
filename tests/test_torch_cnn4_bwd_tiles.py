"""The decomposition of the tiled ``cnn4_block_bwd_params``, in plain
PyTorch, vs JAX.

The kernel recomputes the forward's conv and BN statistics (kernels A and
C of ``cnn4_block_fwd``), takes the BN backward's sums of dz * xhat and dz
per tile of 64 positions, combines them in tile order into dscale, dbias
and dy's constants, forms dy from them, and takes dw as an implicit GEMM
whose reduction over the positions is split into chunks summed in chunk
order. Each step is written out in plain PyTorch beside the kernels' twins
(``cuda/cnn4_cuda.py``) and held here, on numpy inputs from a seed at the
four narrow blocks, against the JAX package's ``_block_bwd`` (dy, dscale,
dbias; ``pallas/cnn4_pallas.py:174``) and ``_conv_s2_bwd`` (dw, db;
``:127``), at ragged tile and chunk sizes.

Tolerances: dw, dscale and dbias within 1e-5 relative, counted against
|want| + max|want| since a sum of mixed signs may sit near zero; dy the
same. db = sum(dy) is zero in exact arithmetic (BN removes dy's mean), so
it is held within 1e-5 of sum(|dy|) per (task, channel), as
``chip_smoke.DB_TOL`` holds it.
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
RTOL = 1e-5
DB_TOL = 1e-5


def _inputs(seed, h, ci):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, h, h, ci)).astype(np.float32)
    w = (rng.normal(size=(B, 3, 3, ci, HIDDEN)) * 0.3).astype(np.float32)
    p = [(rng.normal(size=(B, HIDDEN)) * 0.1).astype(np.float32),
         rng.uniform(0.2, 1.0, size=(B, HIDDEN)).astype(np.float32),
         (rng.normal(size=(B, HIDDEN)) * 0.1).astype(np.float32)]
    ho = tc.out_hw(h)
    g = rng.normal(size=(B, N, ho, ho, HIDDEN)).astype(np.float32)
    return x, w, p, g


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    lim = RTOL * (np.abs(want) + np.abs(want).max())
    assert (np.abs(got - want) <= lim).all(), np.abs(got - want).max()


def _jax_bwd(x, w, p, g, t):
    """JAX's dy, dscale, dbias of task t (``_block_fwd`` for xhat and
    inv_std, then ``_block_bwd``)."""
    _, xh, inv = jp._block_fwd(jnp.asarray(x[t]), jnp.asarray(w[t]),
                               *(jnp.asarray(q[t]) for q in p))
    return jp._block_bwd(jnp.asarray(g[t]), xh, inv, jnp.asarray(p[1][t]),
                         jnp.asarray(p[2][t]))


def _decomposed(x, w, p, g, tile):
    """Steps 1-3 and dy as the kernel takes them -> (dy ``[B, M, C]``,
    dscale, dbias)."""
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    b, s, be = (torch.from_numpy(q) for q in p)
    y = tc.conv_plain(tx, tw, b).reshape(B, -1, HIDDEN)
    mean, var = tc.combine_tile_stats_plain(*tc.tile_stats_plain(y, 64))
    inv = torch.rsqrt(var + tc.EPS)
    tg = torch.from_numpy(g).reshape(B, -1, HIDDEN)
    sx, sz = tc.bwd_tile_sums_plain(y, tg, mean, inv, s, be, tile)
    ds, dbe, m1, m2 = tc.combine_bwd_sums_plain(sx, sz, s, y.shape[1])
    return tc.bwd_dy_plain(y, tg, mean, inv, s, be, m1, m2), ds, dbe


@pytest.mark.parametrize("blk", range(4))
@pytest.mark.parametrize("tile", [64, 10, 13, 1])
def test_tile_sums_match_jax_block_bwd(blk, tile):
    """Per-tile sums combined in tile order give JAX's dscale and dbias,
    and dy formed from them JAX's dy, for tiles that split M raggedly."""
    h, ci = BLOCKS[blk]
    x, w, p, g = _inputs(blk, h, ci)
    m = N * tc.out_hw(h) ** 2
    assert m % tile or tile == 1    # the last tile is ragged
    dy, ds, dbe = _decomposed(x, w, p, g, tile)
    for t in range(B):
        want_dy, want_ds, want_dbe = _jax_bwd(x, w, p, g, t)
        _close(ds[t], want_ds)
        _close(dbe[t], want_dbe)
        _close(dy[t], np.asarray(want_dy).reshape(-1, HIDDEN))


@pytest.mark.parametrize("blk", range(4))
@pytest.mark.parametrize("chunk", [16, 48, 100, None])
def test_split_dw_matches_jax_conv_s2_bwd(blk, chunk):
    """dw and db as chunk partials of the implicit GEMM, summed in chunk
    order, equal JAX's ``_conv_s2_bwd`` on JAX's own dy (None: one chunk
    of all M)."""
    h, ci = BLOCKS[blk]
    x, w, p, g = _inputs(10 + blk, h, ci)
    m = N * tc.out_hw(h) ** 2
    dys = [np.asarray(_jax_bwd(x, w, p, g, t)[0]) for t in range(B)]
    dw, db = tc.dw_split_plain(torch.from_numpy(x),
                               torch.from_numpy(np.stack(dys)), chunk or m)
    for t in range(B):
        want_dw, want_db, _ = jp._conv_s2_bwd(
            jnp.asarray(x[t]), jnp.asarray(dys[t]), jnp.asarray(w[t]))
        _close(dw[t], want_dw)
        lim = DB_TOL * np.abs(dys[t]).sum(axis=(0, 1, 2))
        assert (np.abs(db[t].numpy() - np.asarray(want_db)) <= lim).all()


@pytest.mark.parametrize("blk", range(4))
def test_decomposition_matches_the_twin(blk):
    """All steps at the kernel's sizes (tiles of 64, chunks as
    ``dw_chunk`` picks them) equal the plain twin ``block_bwd_params_plain``
    that the card checks hold the kernel against."""
    h, ci = BLOCKS[blk]
    x, w, p, g = _inputs(20 + blk, h, ci)
    dy, ds, dbe = _decomposed(x, w, p, g, 64)
    chunk = tc.dw_chunk(B, dy.shape[1], ci, HIDDEN)
    dw, db = tc.dw_split_plain(torch.from_numpy(x), dy, chunk)
    want = tc.block_bwd_params_plain(
        *(torch.from_numpy(a) for a in (x, w, *p, g)))
    _close(dy.reshape(want[0].shape), want[0])
    for got, ref in ((dw, want[1]), (ds, want[3]), (dbe, want[4])):
        _close(got, ref)
    lim = DB_TOL * want[0].abs().sum(dim=(1, 2, 3))
    assert ((db - want[2]).abs() <= lim).all()


def test_dw_chunks_cover_every_position_once():
    """The chunking the kernel and the workspace share: a whole number of
    stages per chunk, the chunks tile M with only the last one short, and
    a batch's block 1 gets 9 chunks, its blocks 2-4 one."""
    for b, n, h, ci in [(64, 25, 28, 1), (64, 25, 14, 64), (64, 25, 7, 64),
                        (64, 25, 4, 64), (1, 1, 28, 1), (2, 400, 28, 1),
                        (3, 7, 9, 3)]:
        m = n * tc.out_hw(h) ** 2
        chunk = tc.dw_chunk(b, m, ci, 64)
        chunks = -(-m // chunk)
        assert chunk % 16 == 0 and (chunks - 1) * chunk < m <= chunks * chunk
        if (b, n) == (64, 25):
            assert chunks == (9 if ci == 1 else 1)
