"""The single-task CNN4 route of the port: one thread-block cluster a task.

At B = 1, at the shapes where the cluster beats the tiled launches, the
port's forward and ``bwd_params`` run one launch a block
(``fwd_cluster_kernel``, ``bwd_params_cluster_kernel`` in
``csrc/cnn4_block.cu``), which the card tests in ``test_torch_cuda.py``
hold against the plain twins. Here, on the CPU:

- (a) ``cluster_plan``: at B = 1 the forward's plan at blocks 2-4 where a
  CTA owns one tile (N = 1, 10, 15 at block 2; every N the port launches
  at blocks 3-4) and ``bwd_params``' at block 1 where a CTA owns at most 3
  tiles (N = 1, 10, 15), within 227 KB of shared memory a CTA and a
  cluster of at most 16 CTAs (8 where the device schedules no more); None
  at every other block shape and N, at B = 64 and where Co does not fit;
  its arithmetic as the source's ``cluster_plan`` computes it, by hand at
  a few shapes;
- (b) the emulations of the cluster kernels' summation order
  (``block_fwd_cluster_plain``, ``block_bwd_params_cluster_plain``: per
  rank statistics, BN-backward sums and dw partials, combined in rank
  order) against JAX's ``_blk_fwd_call_single`` / ``_blk_bwd_call_single``
  run in interpret mode, at tests/test_torch_cnn4_kernel.py's tolerances:
  forward 2e-5, gradients rtol 1e-4 / atol 1e-5, the conv-bias gradient
  (zero in exact arithmetic) by its magnitude; dx from the emulation's dy;
- (c) the bf16 emulations against the twins taken in float64, at the
  bf16 contract: one bf16 ulp plus f32 noise, equal in all but
  ``BF16_SHARE`` (1e-2) of the elements (``bf16_agreement``,
  ``bf16_share_holds``); the dw and db partials summed rank by rank.

Inputs are numpy arrays made from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_meta_tpu.pallas import cnn4_pallas as jp
from exploring_meta_tpu_torch.cuda import cnn4_cuda as tc

HIDDEN = 8
# (H, Ci) of the four Omniglot blocks, at the narrow test width and at 64
BLOCKS = [(28, 1), (14, HIDDEN), (7, HIDDEN), (4, HIDDEN)]
FULL = [(28, 1), (14, 64), (7, 64), (4, 64)]
KERNELS = ("cnn4_block_fwd", "cnn4_block_bwd_params")
DTYPES = (torch.float32, torch.bfloat16)


# -- (a) the plan ------------------------------------------------------------

# (kernel, block index) -> the N of 1, 10, 15, 25 the cluster route takes
ROUTED = {("cnn4_block_fwd", 1): (1, 10, 15),
          ("cnn4_block_fwd", 2): (1, 10, 15, 25),
          ("cnn4_block_fwd", 3): (1, 10, 15, 25),
          ("cnn4_block_bwd_params", 0): (1, 10, 15)}


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 10, 15, 25])
def test_plan_at_one_task_for_every_block(n, dtype, kernel):
    for blk, (h, ci) in enumerate(FULL):
        plan = tc.cluster_plan(1, n, h, h, ci, 64, dtype, kernel)
        assert (plan is not None) == (n in ROUTED.get((kernel, blk), ())), (
            blk, n)
        # a batch keeps the tiled kernels
        assert tc.cluster_plan(64, n, h, h, ci, 64, dtype, kernel) is None
        if plan is None:
            continue
        m = n * tc.out_hw(h) ** 2
        assert 1 <= plan.size <= 16 and plan.smem <= 227 * 1024
        assert plan.size == tc.cluster_size(m)
        rows = tc.cluster_rows(m, plan.size)
        # the ranks tile the task's positions in order, none empty; the
        # forward's one tile a CTA, bwd_params' at most three
        assert rows[0][0] == 0 and rows[-1][1] == m
        assert all(a < b for a, b in rows)
        assert all(rows[q][1] == rows[q + 1][0] for q in range(len(rows) - 1))
        assert rows[0][1] <= 64 * (1 if kernel == "cnn4_block_fwd" else 3)


def test_plan_arithmetic_mirrors_the_source():
    """The source's cluster_plan by hand. The forward's ring holds the fat
    stages (bf16: 3 stages of 2 x 64 x 72 halves, 55296 bytes; f32: 2
    stages of 64 x 68 + 64 x 64 floats, 67584); bwd_params' (Ci = 1) the
    tiled path's stages two deep (bf16 19456, f32 20480), and x of the
    images a CTA can read and w are copied. Then 2816 bytes that peers
    read, the position table (8 bytes a position), ceil(tiles / size)
    tiles of 64 x 68 floats (17408 bytes), and for bwd_params dw's partial,
    9 x 68 floats."""
    f32, bf = torch.float32, torch.bfloat16
    bwd = "cnn4_block_bwd_params"
    one = 2816 + 512 + 17408
    # block 1, N = 15: 46 tiles, 3 a CTA on 16 CTAs, which read at most
    # ceil(192 / 196) + 1 = 2 images of 784 elements; w 9 x 64
    three = 2816 + 3 * 512 + 3 * 17408 + 9 * 68 * 4
    assert tc.cluster_plan(1, 15, 28, 28, 1, 64, bf, bwd) == (
        16, 19456 + three + 2 * 784 * 2 + 9 * 64 * 2)
    assert tc.cluster_plan(1, 15, 28, 28, 1, 64, f32, bwd) == (
        16, 20480 + three + 2 * 784 * 4 + 9 * 64 * 4)
    # block 1, N = 1: 4 tiles, one a CTA, one image
    assert tc.cluster_plan(1, 1, 28, 28, 1, 64, f32, bwd) == (
        4, 20480 + one + 9 * 68 * 4 + 784 * 4 + 9 * 64 * 4)
    # N = 16 is 49 tiles, 4 a CTA: tiled
    assert tc.cluster_plan(1, 16, 28, 28, 1, 64, f32, bwd) is None
    # block 2, N = 15: 12 tiles, one a CTA; N = 16: 13
    assert tc.cluster_plan(1, 15, 14, 14, 64, 64, bf) == (12, 55296 + one)
    assert tc.cluster_plan(1, 16, 14, 14, 64, 64, f32) == (13, 67584 + one)
    # block 2, N = 21 is 1029 positions, 17 tiles: tiled
    assert tc.cluster_plan(1, 21, 14, 14, 64, 64, f32) is None
    # on a device that schedules clusters of 8 at most, one tile a CTA is
    # 512 positions
    assert tc.cluster_plan(1, 10, 14, 14, 64, 64, f32, max_size=8) == (
        8, 67584 + one)
    assert tc.cluster_plan(1, 11, 14, 14, 64, 64, f32, max_size=8) is None
    # and block 1 at N = 10 is 31 tiles, 4 a CTA of 8: tiled; N = 5, 2
    assert tc.cluster_plan(1, 10, 28, 28, 1, 64, f32, bwd, 8) is None
    assert tc.cluster_plan(1, 5, 28, 28, 1, 64, f32, bwd, 8).size == 8
    # block 4, N = 25: 2 tiles; N = 1: 4 positions, one CTA
    assert tc.cluster_plan(1, 25, 4, 4, 64, 64, bf) == (2, 55296 + one)
    assert tc.cluster_plan(1, 1, 4, 4, 64, 64, f32) == (1, 67584 + one)
    # the other kernel's blocks, channels the route does not take (Co past
    # 64 or not a multiple of 8; Ci neither a multiple of 64 nor 1), no
    # positions, two tasks
    assert tc.cluster_plan(1, 10, 28, 28, 1, 64, f32) is None
    assert tc.cluster_plan(1, 10, 14, 14, 64, 64, f32, bwd) is None
    for args in ((1, 10, 14, 14, 64, 72), (1, 10, 14, 14, 64, 12),
                 (1, 10, 14, 14, 32, 64), (1, 10, 14, 14, 8, 64),
                 (1, 10, 9, 9, 3, 64), (1, 0, 14, 14, 64, 64),
                 (2, 10, 14, 14, 64, 64)):
        assert tc.cluster_plan(*args, f32) is None, args
        assert tc.cluster_plan(*args, f32, bwd) is None, args
    assert tc.cluster_plan(1, 10, 14, 14, 64, 32, f32) == (8, 67584 + one)
    assert tc.cluster_plan(1, 10, 9, 9, 1, 64, bf, bwd) is not None


def test_cpu_calls_take_the_twins_and_count_no_route():
    tc.reset_launch_counts()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1, 2, 7, 7, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(1, 3, 3, 8, 8)).astype(np.float32))
    p = [torch.ones(1, 8)] * 3
    got = tc.block_fwd(x, w, *p)
    torch.testing.assert_close(got, tc.block_fwd_plain(x, w, *p))
    assert not any(tc.routes().values())
    assert set(tc.routes()) == {"fwd_cluster_kernel", "fwd_tiled",
                                "bwd_params_cluster_kernel",
                                "bwd_params_tiled", "double_bwd_kernels",
                                "double_bwd_plain"}


# -- (b) the emulations against JAX's single-task kernels ---------------------

def _inputs(seed, n, h, ci, co=HIDDEN):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, h, ci)).astype(np.float32)
    w = (rng.normal(size=(3, 3, ci, co)) * (2.0 / (9 * ci)) ** 0.5
         ).astype(np.float32)
    b = (rng.normal(size=(co,)) * 0.1).astype(np.float32)
    s = rng.uniform(0.2, 1.0, size=(co,)).astype(np.float32)
    be = (rng.normal(size=(co,)) * 0.1).astype(np.float32)
    ho = tc.out_hw(h)
    g = rng.normal(size=(n, ho, ho, co)).astype(np.float32)
    return x, (w, b, s, be), g


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).unsqueeze(0).to(dtype)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("n", [1, 10, 25])
@pytest.mark.parametrize("blk", range(4))
def test_cluster_emulations_match_the_single_task_pallas_kernels(blk, n):
    h, ci = BLOCKS[blk]
    x, p4, g = _inputs(100 * blk + n, n, h, ci)
    size = tc.cluster_size(n * tc.out_hw(h) ** 2)
    jp4 = tuple(map(jnp.asarray, p4))
    want = jp._blk_fwd_call_single(jp4, jnp.asarray(x))
    tp4 = [_t(p) for p in p4]
    got = tc.block_fwd_cluster_plain(_t(x), *tp4)[0]
    _close(got, want, 2e-5, 2e-5)
    want = jp._blk_bwd_call_single(jp4, jnp.asarray(x), jnp.asarray(g))
    dy, dw, db, ds, dbe = tc.block_bwd_params_cluster_plain(_t(x), *tp4,
                                                            _t(g))
    dx = tc.block_bwd_input_plain(dy, tp4[0], h, h)
    for i, (a, c) in enumerate(zip((dw, db, ds, dbe, dx), want)):
        a = a[0].numpy()
        if i == 1:    # db = sum(dy): f32 rounding noise on both sides
            assert np.abs(a).max() < 1e-4
            assert np.abs(np.asarray(c)).max() < 1e-4
        else:
            _close(a, c, 1e-4, 1e-5)
    if n == 25:    # the ranks really split the task: 16, 10, 7 and 2 CTAs
        assert size == (16, 10, 7, 2)[blk]


# -- (c) the bf16 emulation against the float64 twins ---------------------------

def _bf16_block(seed, n, h, ci, co=64):
    x, (w, b, s, be), g = _inputs(seed, n, h, ci, co)
    return [_t(a, torch.bfloat16) for a in (x, w, b, s, be, g)]


@pytest.mark.parametrize("n", [10, 25])
@pytest.mark.parametrize("blk", range(4))
def test_bf16_cluster_emulation_holds_the_bf16_contract(blk, n):
    """Every bf16 output but db within one bf16 ulp (plus f32 noise) of
    the twin taken in float64, equal to it in all but BF16_SHARE of its
    elements; dy (f32) within float32's 1e-4; db by its magnitude."""
    h, ci = FULL[blk]
    x, w, b, s, be, g = _bf16_block(200 + 10 * blk + n, n, h, ci)
    # the kink mask of the cotangent, as the card checks take it
    xh, _, sc, bias = tc.bn_stats_plain(x, w, b, s, be)
    g = (g.float() * ((xh * sc + bias).abs() > 1e-3)).to(torch.bfloat16)
    f64 = torch.float64
    checks = [(tc.block_fwd_cluster_plain(x, w, b, s, be),
               tc.block_fwd_plain(x, w, b, s, be, acc=f64))]
    got = tc.block_bwd_params_cluster_plain(x, w, b, s, be, g)
    want = tc.block_bwd_params_plain(x, w, b, s, be, g, acc=f64)
    checks += [(got[i], want[i]) for i in (1, 3, 4)]
    for a, c in checks:
        assert a.dtype == torch.bfloat16
        over, share = tc.bf16_agreement(a, c)
        assert over <= 1.0 and tc.bf16_share_holds(share, c.numel()), (
            over, share)
    torch.testing.assert_close(got[0], want[0].float(), rtol=1e-4,
                               atol=1e-4 * float(want[0].abs().max()))
    lim = 2e-2 * want[0].abs().sum(dim=(1, 2, 3))
    assert ((got[2].double() - want[2].double()).abs() <= lim).all()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_bwd_emulation_sums_rank_partials_in_order(dtype):
    """At block 1, N = 15 (16 ranks of 3 tiles): dw and db of the emulation
    are each rank's partial over its 192 positions, from the f32 dy, summed
    in rank order (dw_split_plain with a rank's rows as the chunk), in
    either dtype."""
    x, w, b, s, be, g = (t.to(dtype) for t in _bf16_block(7, 15, 28, 1))
    size = tc.cluster_plan(1, 15, 28, 28, 1, 64, dtype,
                           "cnn4_block_bwd_params").size
    per = tc.cluster_rows(15 * 196, size)[0][1]
    assert (size, per) == (16, 192)
    dy, dw, db = tc.block_bwd_params_cluster_plain(x, w, b, s, be, g)[:3]
    want, wantdb = tc.dw_split_plain(x, dy, per)
    assert torch.equal(dw, want.to(dtype)) and torch.equal(db, wantdb.to(
        dtype))
