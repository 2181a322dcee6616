"""The port's bfloat16 CNN4 block path against the JAX Pallas kernels, and
the plain emulation of the bf16 kernels' tensor-core arithmetic.

On the card the bf16 forward's conv and ``cnn4_block_bwd_params``' dw run
on the tensor cores (bf16 products, f32 accumulation), dw's f32 operand
dy as three bf16 terms hi + mid + lo. Here, on the CPU, the wrappers take
their plain twins; these tests hold

- the twins on bf16 inputs against JAX's four call sites
  (``_blk_fwd_call_single``, ``_blk_bwd_call_single``,
  ``_blk_fwd_pallas_batched``, ``_blk_bwd_pallas_batched``) run in
  interpret mode, at the four narrow block shapes: both sides upcast the
  same bf16 inputs and compute in f32, so each bf16 output lies within one
  bf16 ulp plus f32 noise of JAX's, ``|port - jax| <= 2^-7 |jax| + 1e-5
  max|jax|`` (``cnn4_cuda.bf16_agreement``); the conv-bias gradient, f32
  rounding noise on both sides, by its magnitude;
- ``split3_bf16``: hi + mid + lo == dy exactly for 0 and 2^-110 <= |dy| <=
  the largest bf16, and within bf16's least subnormal below;
- ``dw_split3_plain`` (the kernel's arithmetic) against ``dw_split_plain``
  (f32 dy) and JAX's ``_conv_s2_bwd`` at the f32 tolerance, rtol 1e-4 /
  atol 1e-5 x max|dw|; rounded to bf16 it differs from the twin's bf16 dw
  in at most ``BF16_SHARE`` of the elements, where a dw from dy rounded to
  one bf16 differs in far more;
- ``dx_split3_plain`` (``bwd_input_tc_kernel``'s arithmetic: per parity
  class and stage of 32 channels, dy's three terms times w summed from
  zero, then added in f32) against JAX's dx from the two backward call
  sites and from ``_conv_s2_bwd`` at the f32 tolerance, rtol 1e-4 / atol
  1e-5 x max|dx|; rounded to bf16 against ``block_bwd_input_plain`` taken
  in float64 within ``BF16_SHARE``, where a dx from dy rounded to one bf16
  (``rounded_dy_dx_share``) misses that share many times over.
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
BLOCKS = [(28, 1), (14, HIDDEN), (7, HIDDEN), (4, HIDDEN)]


def _bf16_inputs(seed, h, ci, b=None):
    """bf16-valued x, (w, b, scale, bias) and g as numpy f32 arrays (each
    exactly a bf16), so both sides start from the same bf16 numbers."""
    rng = np.random.default_rng(seed)
    lead = () if b is None else (b,)

    def bf(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            torch.bfloat16).float().numpy()

    x = bf(rng.normal(size=lead + (N, h, h, ci)))
    p4 = (bf(rng.normal(size=lead + (3, 3, ci, HIDDEN)) * 0.3),
          bf(rng.normal(size=lead + (HIDDEN,)) * 0.1),
          bf(rng.uniform(0.2, 1.0, size=lead + (HIDDEN,))),
          bf(rng.normal(size=lead + (HIDDEN,)) * 0.1))
    ho = tc.out_hw(h)
    g = bf(rng.normal(size=lead + (N, ho, ho, HIDDEN)))
    return x, p4, g


def _jax(a):
    return jnp.asarray(a, dtype=jnp.bfloat16)


def _port(a, batch):
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t if batch else t.unsqueeze(0)


def _within_ulp(got, want):
    got = torch.as_tensor(np.asarray(got, np.float32)) \
        if not torch.is_tensor(got) else got
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    over, _ = tc.bf16_agreement(got.reshape(want.shape), want)
    assert over <= 1.0, over


def _check(port_fwd, port_bwd, jax_fwd, jax_bwd):
    assert port_fwd.dtype == torch.bfloat16
    _within_ulp(port_fwd, jax_fwd)
    for i, (a, b) in enumerate(zip(port_bwd, jax_bwd)):
        assert a.dtype == torch.bfloat16
        if i == 1:      # db = sum(dy): zero but for f32 rounding, both sides
            assert float(a.float().abs().max()) < 1e-4
            assert float(jnp.abs(jnp.asarray(b, jnp.float32)).max()) < 1e-4
        else:
            _within_ulp(a.float(), b)


def _port_bwd(x, p4, g):
    dy, dw, db, ds, dbe = tc.block_bwd_params(x, *p4, g)
    assert dy.dtype == torch.float32
    dx = tc.block_bwd_input(dy, p4[0], x.shape[2], x.shape[3])
    return dw, db, ds, dbe, dx


@pytest.mark.parametrize("blk", range(4))
def test_single_task_bf16_block_matches_pallas(blk):
    h, ci = BLOCKS[blk]
    x, p4, g = _bf16_inputs(20 + blk, h, ci)
    jp4 = tuple(map(_jax, p4))
    want_f = jp._blk_fwd_call_single(jp4, _jax(x))
    want_b = jp._blk_bwd_call_single(jp4, _jax(x), _jax(g))
    tp4 = [_port(p, False) for p in p4]
    got_f = tc.block_fwd(_port(x, False), *tp4)[0]
    got_b = [t[0] for t in _port_bwd(_port(x, False), tp4, _port(g, False))]
    _check(got_f, got_b, want_f, want_b)


@pytest.mark.parametrize("blk", range(4))
def test_batched_bf16_block_matches_pallas(blk):
    h, ci = BLOCKS[blk]
    x, p4, g = _bf16_inputs(30 + blk, h, ci, b=B)
    jp4 = tuple(map(_jax, p4))
    want_f = jp._blk_fwd_pallas_batched(jp4, _jax(x))
    want_b = jp._blk_bwd_pallas_batched(jp4, _jax(x), _jax(g))
    tp4 = [_port(p, True) for p in p4]
    got_f = tc.block_fwd(_port(x, True), *tp4)
    got_b = _port_bwd(_port(x, True), tp4, _port(g, True))
    _check(got_f, got_b, want_f, want_b)


def test_split3_reproduces_f32_exactly():
    """hi + mid + lo == d bit for bit over random bit patterns from 2^-110
    to the largest bf16, both signs, and at 0; below 2^-110 (f32
    subnormals included) the loss is under bf16's least subnormal."""
    rng = np.random.default_rng(0)
    exps = rng.integers(-110, 127, size=20000)
    mant = rng.uniform(1.0, 2.0, size=20000)
    sign = rng.choice([-1.0, 1.0], size=20000)
    d = torch.tensor(sign * mant * np.exp2(exps.astype(np.float64)),
                     dtype=torch.float32)
    bf_max = float(torch.finfo(torch.bfloat16).max)
    d = torch.cat([d[d.abs() <= bf_max], torch.tensor(
        [0.0, -0.0, 2.0 ** -110, -(2.0 ** -110), bf_max, -bf_max, 1e38])])
    hi, mid, lo = tc.split3_bf16(d)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    # summed small first, every partial sum exact in f32
    total = (lo.float() + mid.float()) + hi.float()
    assert torch.equal(total, d)
    assert bool((hi.float().abs() >= mid.float().abs()).all())
    tiny = torch.tensor([2.0 ** -149, 1e-40, -3e-39, 2.0 ** -126, 1e-35,
                         -(2.0 ** -111) * 1.7], dtype=torch.float32)
    t3 = tc.split3_bf16(tiny)
    err = ((t3[2].float() + t3[1].float()) + t3[0].float() - tiny).abs()
    assert float(err.max()) < 2.0 ** -133
    # one bf16 alone loses up to 2^-9 of each value
    assert float((hi.float() - d).abs().max()) > 0


def _dw_inputs(seed, b=2, n=8, h=14, ci=16, co=32):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(b, n, h, h, ci)).astype(
        np.float32)).to(torch.bfloat16)
    ho = tc.out_hw(h)
    dy = torch.from_numpy(rng.normal(size=(b, n * ho * ho, co)).astype(
        np.float32)) * 1e-2
    return x, dy


@pytest.mark.parametrize("h,chunk", [(14, 1232), (14, 96), (28, 560),
                                     (7, 64), (4, 16)])
def test_three_term_dw_holds_f32_precision(h, chunk):
    """The tensor-core dw (bf16 x times three bf16 terms of dy, a k-step's
    products summed from zero, then the chunk in f32) against the f32-dy
    GEMM and JAX's ``_conv_s2_bwd`` at rtol 1e-4 / atol 1e-5 x max|dw|,
    at chunks as ``dw_chunk`` cuts them (one chunk of all M, ragged
    chunks, ragged k-steps)."""
    x, dy = _dw_inputs(h, h=h)
    got = tc.dw_split3_plain(x, dy, chunk)
    want, _ = tc.dw_split_plain(x, dy, chunk)
    top = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * top)
    ho = tc.out_hw(h)
    for t in range(x.shape[0]):
        jdw, _, _ = jp._conv_s2_bwd(
            jnp.asarray(x[t].float().numpy()),
            jnp.asarray(dy[t].reshape(-1, ho, ho, dy.shape[-1]).numpy()),
            jnp.zeros((3, 3, x.shape[-1], dy.shape[-1]), jnp.float32))
        np.testing.assert_allclose(got[t].numpy(), np.asarray(jdw),
                                   rtol=1e-4, atol=1e-5 * top)


def test_rounding_dy_to_one_bf16_fails_the_share():
    """Rounded to bf16, the three-term dw equals the f32-dy dw's rounding
    in all but BF16_SHARE of the elements; a dw from dy rounded to one
    bf16 misses that share many times over."""
    x, dy = _dw_inputs(1, n=25)
    want, _ = tc.dw_split_plain(x, dy, 10 ** 6)
    got = tc.dw_split3_plain(x, dy, 10 ** 6)
    rounded, _ = tc.dw_split_plain(x, dy.to(torch.bfloat16).float(), 10 ** 6)
    over, share = tc.bf16_agreement(got.to(torch.bfloat16),
                                    want.to(torch.bfloat16))
    assert over <= 1.0 and share <= tc.BF16_SHARE, (over, share)
    _, bad = tc.bf16_agreement(rounded.to(torch.bfloat16),
                               want.to(torch.bfloat16))
    assert bad > 20 * tc.BF16_SHARE, bad


def test_bf16_agreement_counts_differences():
    want = torch.tensor([1.0, 2.0, 0.0, -4.0]).to(torch.bfloat16)
    assert tc.bf16_agreement(want, want) == (0.0, 0.0)
    got = want.clone()
    got[1] = torch.tensor(2.0 + 2.0 ** -6)     # one ulp at 2
    over, share = tc.bf16_agreement(got, want)
    assert share == 0.25 and over <= 1.0
    got[2] = 1e-3                               # past 1e-5 max|want|
    assert tc.bf16_agreement(got, want)[0] > 1.0


@pytest.mark.parametrize("n,share,holds", [
    (64, 1 / 64, True),          # one tie in 64 elements
    (64, 2 / 64, False),
    (10 ** 5, 1e-2, True),
    (10 ** 5, 1e-2 + 1e-5, False),
    (1, 0.0, True)])
def test_bf16_share_holds_rounds_up_to_a_whole_element(n, share, holds):
    assert tc.BF16_SHARE == 1e-2
    assert tc.bf16_share_holds(share, n) is holds


def test_block_inputs_and_the_rounded_dy_control_on_the_cpu():
    """The card checks' inputs (no cotangent within 1e-3 of a ReLU kink)
    and their control: at a narrow block 2, the f32 twin's bf16 dw agrees
    with the float64 twin's within BF16_SHARE, a dw from dy rounded to one
    bf16 misses it many times over."""
    gen = torch.Generator().manual_seed(0)
    x, w, b, sc, be, g = tc.block_inputs(gen, 2, 5, 14, 16, HIDDEN,
                                         torch.bfloat16)
    assert x.shape == (2, 5, 14, 14, 16) and w.shape == (2, 3, 3, 16, HIDDEN)
    assert all(t.dtype == torch.bfloat16 for t in (x, w, b, sc, be, g))
    xh, _, s, bias = tc.bn_stats_plain(x, w, b, sc, be)
    assert bool((g[(xh * s + bias).abs() <= 1e-3] == 0).all())
    dw32 = tc.block_bwd_params_plain(x, w, b, sc, be, g)[1]
    dw64 = tc.block_bwd_params_plain(x, w, b, sc, be, g,
                                     acc=torch.float64)[1]
    over, share = tc.bf16_agreement(dw32, dw64)
    assert over <= 1.0 and tc.bf16_share_holds(share, dw64.numel())
    assert tc.rounded_dy_share(x, w, b, sc, be, g) > 10 * tc.BF16_SHARE


def _f32_dy(x, p4, g, batch):
    """The f32 dy that the backward call sites form inside, from the same
    bf16-valued inputs in f32 (the port's twin)."""
    t = [torch.from_numpy(a) if batch else torch.from_numpy(a).unsqueeze(0)
         for a in (x, *p4, g)]
    return tc.block_bwd_params_plain(*t)[0], t[1]


@pytest.mark.parametrize("batch", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("blk", range(4))
def test_three_term_dx_matches_the_pallas_backward(blk, batch):
    """dx_split3_plain from the f32 dy against the dx of
    ``_blk_bwd_call_single`` / ``_blk_bwd_pallas_batched`` (interpret
    mode) on the same bf16-valued inputs in f32, at the f32 tolerance."""
    h, ci = BLOCKS[blk]
    x, p4, g = _bf16_inputs(40 + blk, h, ci, b=B if batch else None)
    jp4 = tuple(jnp.asarray(p) for p in p4)
    call = jp._blk_bwd_pallas_batched if batch else jp._blk_bwd_call_single
    want = np.asarray(call(jp4, jnp.asarray(x), jnp.asarray(g))[4])
    dy, w = _f32_dy(x, p4, g, batch)
    got = tc.dx_split3_plain(dy, w.to(torch.bfloat16), h, h)
    assert got.dtype == torch.float32
    got = got.numpy() if batch else got[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))


def _dx_inputs(seed, b=2, n=5, h=14, ci=16, co=64):
    rng = np.random.default_rng(seed)
    ho = tc.out_hw(h)
    dy = torch.from_numpy(rng.normal(size=(b, n, ho, ho, co)).astype(
        np.float32)) * 1e-2
    w = torch.from_numpy((rng.normal(size=(b, 3, 3, ci, co))
                          * (2.0 / (9 * ci)) ** 0.5).astype(np.float32))
    return dy, w.to(torch.bfloat16)


@pytest.mark.parametrize("h,ci,co", [(28, 1, 64), (14, 16, 64), (7, 16, 64),
                                     (4, 16, 64), (9, 8, 40), (6, 3, 8)])
def test_three_term_dx_holds_f32_precision(h, ci, co):
    """Across several stages a tap (Co 64: two; 40: a ragged second) and
    odd extents, dx_split3_plain against the f32-dy dx of
    ``block_bwd_input_plain`` and of JAX's ``_conv_s2_bwd`` at rtol 1e-4
    / atol 1e-5 x max|dx|."""
    dy, w = _dx_inputs(h + ci, h=h, ci=ci, co=co)
    got = tc.dx_split3_plain(dy, w, h, h)
    want = tc.block_bwd_input_plain(dy, w.float(), h, h)
    top = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * top)
    x0 = jnp.zeros((dy.shape[1], h, h, ci), jnp.float32)
    for t in range(dy.shape[0]):
        _, _, jdx = jp._conv_s2_bwd(x0, jnp.asarray(dy[t].numpy()),
                                    jnp.asarray(w[t].float().numpy()))
        np.testing.assert_allclose(got[t].numpy(), np.asarray(jdx),
                                   rtol=1e-4, atol=1e-5 * top)


@pytest.mark.parametrize("h,ci", [(14, 16), (7, 16), (4, 16)])
def test_rounding_dy_to_one_bf16_fails_the_dx_share(h, ci):
    """Rounded to bf16, the three-term dx lies within one bf16 ulp of the
    float64 twin's and equals it in all but BF16_SHARE of the elements; a
    dx from dy rounded to one bf16 misses that share many times over."""
    dy, w = _dx_inputs(3 * h, n=25, h=h, ci=ci)
    want = tc.block_bwd_input_plain(dy, w, h, h, acc=torch.float64)
    assert want.dtype == torch.bfloat16
    got = tc.dx_split3_plain(dy, w, h, h).to(torch.bfloat16)
    over, share = tc.bf16_agreement(got, want)
    assert over <= 1.0 and tc.bf16_share_holds(share, want.numel()), (
        over, share)
    bad = tc.rounded_dy_dx_share(dy, w, h, h)
    assert bad > 20 * tc.BF16_SHARE, bad
