"""The CNN4 block's second-order VJP (``cnn4_block_double_bwd``): its
plain twin against autograd, and against the JAX package's.

``block_double_bwd_plain`` is the analytic VJP of the block's backward
``(x, w, b, scale, bias, g) -> (dx, dw, db, dscale, dbias)``; the kernels
on the card compute the same sums (tests/test_torch_cuda.py holds them to
it). Here, in float64, it is held against ``torch.autograd`` taken twice
through ``_reference_block`` (the per-op block) at the four full-width
Omniglot block shapes, with dx wanted and not, at one task and at three
tasks with per-task weights, each cotangent fed alone and all together
(a dropped or wrong term fails its case); against the VJP of JAX's
``_pure_grads`` at one block; and, through ``FusedBlockBackward``, its
route count and its None cotangents.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_meta_tpu.pallas import cnn4_pallas as jp
from exploring_meta_tpu_torch.cuda import cnn4_cuda as tc

F64 = torch.float64
CO, N = 64, 2
BLOCKS = [(28, 1), (14, 64), (7, 64), (4, 64)]
NAMES = ("dx", "dw", "db", "dscale", "dbias")
# (need_dx, which cotangent: an index into NAMES or "all"); without dx
# there is no dx cotangent to feed alone
COTS = [(nd, c) for nd in (True, False) for c in (*range(5), "all")
        if nd or c != 0]


def _inputs(rng, b, h, ci):
    def t(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape) * scale, dtype=F64)
    x = t(b, N, h, h, ci)
    w = t(b, 3, 3, ci, CO, scale=(2.0 / (9 * ci)) ** 0.5)
    p = [t(b, CO, scale=0.1),
         torch.tensor(rng.uniform(0.1, 1.0, size=(b, CO)), dtype=F64),
         t(b, CO, scale=0.1)]
    ho = tc.out_hw(h)
    return x, w, p, t(b, N, ho, ho, CO)


def _cotangents(rng, x, w, which, need_dx):
    shapes = [x.shape, w.shape] + [(x.shape[0], CO)] * 3
    cots = [torch.tensor(rng.normal(size=s), dtype=F64) for s in shapes]
    if not need_dx:
        cots[0] = None
    if which != "all":
        cots = [c if i == which else None for i, c in enumerate(cots)]
    return cots


def _autograd_vjp(x, w, p, g, cots, need_dx):
    """The VJP of the block's backward by autograd through
    ``_reference_block``: -> grads of (x, w, b, scale, bias, g), None
    where unused or not asked for."""
    ins = [t.clone().requires_grad_(on) for t, on in
           zip((x, w, *p, g), (need_dx, True, True, True, True, True))]
    first = torch.autograd.grad(tc._reference_block(*ins[:5]),
                                ins[:5] if need_dx else ins[1:5], ins[5],
                                create_graph=True)
    first = list(first) if need_dx else [None, *first]
    pairs = [(f, c) for f, c in zip(first, cots) if c is not None]
    targets = [t for t in ins if t.requires_grad]
    got = iter(torch.autograd.grad([f for f, _ in pairs], targets,
                                   [c for _, c in pairs], allow_unused=True))
    return [next(got) if t.requires_grad else None for t in ins]


def _held(got, want, what):
    """float64 on both sides: within 1e-10 of the largest |want|; a grad
    autograd leaves unused (None) or all zero must be None or zero."""
    for name, a, b in zip(("x", "w", "b", "scale", "bias", "g"), got, want):
        if b is None or not bool(b.any()):
            assert a is None or float(a.abs().max()) <= 1e-12, (what, name)
            continue
        assert a is not None, (what, name)
        tol = 1e-10 * max(float(b.abs().max()), 1.0)
        assert float((a - b).abs().max()) <= tol, (what, name)


@pytest.mark.parametrize("need_dx,which", COTS)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("h,ci", BLOCKS)
def test_twin_is_the_autograd_vjp(h, ci, b, need_dx, which):
    rng = np.random.default_rng(h * 10 + b)
    x, w, p, g = _inputs(rng, b, h, ci)
    cots = _cotangents(rng, x, w, which, need_dx)
    want = _autograd_vjp(x, w, p, g, cots, need_dx)
    got = tc.block_double_bwd_plain(x, w, *p, g, cots, need_x=need_dx,
                                    acc=F64)
    assert got[4] is None     # bias reaches the backward only through a mask
    _held(got, want, (h, ci, b, need_dx, which))


def test_twin_matches_the_vjp_of_jax_pure_grads():
    """One block (block 2 at full width, one task) as JAX's second order
    sees it: the VJP of ``_pure_grads`` (the first derivatives of the
    spatially pooled block) at cotangents of the block params and of dx,
    in float64 on both sides. The twin takes the pooled cotangent spread
    over the Ho x Wo positions, and its g_bar pooled back."""
    rng = np.random.default_rng(7)
    h, ci = 14, 64
    x, w, p, _ = _inputs(rng, 1, h, ci)
    ho = tc.out_hw(h)
    gp = rng.normal(size=(N, CO))
    cots = _cotangents(rng, x, w, "all", True)
    with jax.enable_x64(True):
        a = lambda t: jnp.asarray(t[0].numpy())   # noqa: E731
        blocks = [{"conv": {"w": a(w), "b": a(p[0])},
                   "bn": {"scale": a(p[1]), "bias": a(p[2])}}]
        _, vjp = jax.vjp(jp._pure_grads, blocks, a(x), jnp.asarray(gp))
        cb = [{"conv": {"w": a(cots[1]), "b": a(cots[2])},
               "bn": {"scale": a(cots[3]), "bias": a(cots[4])}}]
        jb, jx, jg = jax.tree_util.tree_map(np.asarray,
                                            vjp((cb, a(cots[0]))))
    g = torch.tensor(np.broadcast_to(gp[:, None, None, :] / (ho * ho),
                                     (N, ho, ho, CO))[None].copy(),
                     dtype=F64)
    xb, wb, bb, sb, beb, gb = tc.block_double_bwd_plain(
        x, w, *p, g, cots, acc=F64)
    want = {"x": jx, "w": jb[0]["conv"]["w"],
            "scale": jb[0]["bn"]["scale"], "g": jg}
    got = {"x": xb[0], "w": wb[0], "scale": sb[0],
           "g": gb[0].sum(dim=(1, 2)) / (ho * ho)}
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-9,
                                   atol=1e-9 * np.abs(v).max(), err_msg=k)
    # b_bar = sum y_bar is zero in exact arithmetic (BN removes the conv
    # bias): float64 rounding on both sides
    lim = 1e-12 * np.abs(want["w"]).max()
    assert np.abs(jb[0]["conv"]["b"]).max() <= lim
    assert float(bb.abs().max()) <= lim
    assert beb is None and np.abs(jb[0]["bn"]["bias"]).max() == 0.0


def test_fused_block_backward_takes_the_twin_and_counts_its_route():
    """Second order through ``FusedBlock`` on the CPU (its twins compute in
    float32): the block's double backward is one call of the plain route,
    and the meta-gradient of one block is autograd's through
    ``_reference_block`` in float64 within float32 rounding (1e-4 of each
    gradient's largest element)."""
    rng = np.random.default_rng(3)
    x, w, p, _ = _inputs(rng, 2, 7, 64)
    probe = torch.tensor(rng.normal(size=(2, N, 4, 4, CO)))

    def meta(block, dtype):
        xin, *params = (t.to(dtype).requires_grad_() for t in (x, w, *p))
        out = block(xin, *params)
        first = torch.autograd.grad((out * probe.to(dtype)).sum(),
                                    [xin, *params], create_graph=True)
        loss = sum((f * f).sum() for f in first)
        # bias reaches the first derivatives only through the ReLU mask
        return torch.autograd.grad(loss, [xin, *params], allow_unused=True)

    tc.reset_launch_counts()
    got = meta(tc.FusedBlock.apply, torch.float32)
    assert tc.routes()["double_bwd_plain"] == 1
    assert tc.routes()["double_bwd_kernels"] == 0
    assert tc.launch_counts() == dict.fromkeys(tc.KERNELS, 0)
    want = meta(tc._reference_block, F64)
    assert got[4] is None and not bool(want[4].any())
    for i in (0, 1, 3):
        torch.testing.assert_close(got[i].double(), want[i], rtol=1e-4,
                                   atol=1e-4 * float(want[i].abs().max()))
    # the conv bias's is zero in exact arithmetic (BN removes the bias):
    # float32 rounding, held by its size against the scale's
    assert float(got[2].abs().max()) <= 1e-4 * float(want[3].abs().max())


def test_none_cotangents_add_no_terms():
    """Where no cotangent reaches the block's backward the VJP is zero
    everywhere, and a missing cotangent equals a zero one."""
    rng = np.random.default_rng(5)
    x, w, p, g = _inputs(rng, 2, 14, 64)
    none = tc.block_double_bwd_plain(x, w, *p, g, [None] * 5, acc=F64)
    assert all(t is None or not bool(t.any()) for t in none)
    cots = _cotangents(rng, x, w, "all", True)
    cots[2] = None
    zeros = list(cots)
    zeros[2] = torch.zeros(2, CO, dtype=F64)
    for a, b in zip(tc.block_double_bwd_plain(x, w, *p, g, cots, acc=F64),
                    tc.block_double_bwd_plain(x, w, *p, g, zeros, acc=F64)):
        assert (a is None and b is None) or torch.equal(a, b)


def test_double_bwd_workspace_floats():
    """The scratch of ``launch_double_bwd``: y and v, the statistics, the
    sums, the constants, each rounded up to 16 bytes, and the wgrad
    partials where the positions are split (block 1 at B = 32, N = 25:
    9 rows of dw a task, so the positions split)."""
    b, m, t = 32, 25 * 14 * 14, tc._cdiv(25 * 14 * 14, 64)
    chunks = tc._cdiv(m, tc.dw_chunk(b, m, 1, CO))
    assert chunks > 1
    want = (2 * b * m * CO + 2 * b * t * CO + 2 * b * CO + 5 * b * t * CO
            + 8 * b * CO + b * chunks * (9 * CO + CO))
    assert tc.double_bwd_workspace_floats(b, 25, 28, 28, 1, CO) == want
    # block 4 at B = 1: one chunk; Co = 3 rounds every part up
    assert tc.double_bwd_workspace_floats(1, 1, 4, 4, 64, 3) == (
        12 + 12 + 8 + 8 + 16 + 24)
    assert tc.double_bwd_workspace_floats(0, 25, 28, 28, 1, CO) == 0
