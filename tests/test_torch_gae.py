"""GAE / discount sweeps of the PyTorch port vs the JAX package.

The port's plain twins (``cuda/gae_cuda.py``), and ``ops/gae.py`` which
routes to them on the CPU, are held against the JAX Pallas kernels
(``gae_pallas`` / ``discount_pallas``, which run in interpret mode on the
CPU backend) and against JAX ``ops.gae`` with ``use_pallas=False``, on the
same numpy inputs, at ``[T]``, ``[T, E]`` and ``[B, T, E]`` (JAX under
``vmap``, which takes the kernels' custom vmap rule). Tolerance: 1e-6 of
max|out|, the float32 rounding of a T = 12 sweep.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_meta_tpu.ops import gae as jgae
from exploring_meta_tpu.pallas import discount_pallas, gae_pallas
from exploring_meta_tpu_torch.cuda import gae_cuda
from exploring_meta_tpu_torch.ops import gae as tgae

GAMMA, TAU = 0.97, 0.9
T, E, B = 12, 4, 3
SHAPES = {"T": (T,), "TE": (T, E), "BTE": (B, T, E)}


def _inputs(shape, seed, dones="mid"):
    rng = np.random.default_rng(seed)
    r = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    if dones == "mid":
        d = (rng.uniform(size=shape) < 0.2).astype(np.float32)
    else:
        d = np.full(shape, float(dones == "ones"), np.float32)
    return r, d, v


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def _jax(fn, shape):
    """Run a single-trajectory JAX fn, under vmap for a task batch."""
    return jax.vmap(fn) if len(shape) == 3 else fn


def _t(a):
    return torch.as_tensor(a)


@pytest.mark.parametrize("layout", list(SHAPES))
@pytest.mark.parametrize("dones", ["mid", "zeros", "ones"])
def test_sweeps_match_pallas_and_xla(layout, dones):
    shape = SHAPES[layout]
    r, d, v = _inputs(shape, 0, dones)
    j_gae = _jax(lambda r, d, v: gae_pallas(GAMMA, TAU, r, d, v), shape)
    j_gae_xla = _jax(lambda r, d, v: jgae.generalized_advantage(
        GAMMA, TAU, r, d, v, 0.0, use_pallas=False), shape)
    j_disc = _jax(lambda r, d: discount_pallas(GAMMA, r, d), shape)
    j_disc_xla = _jax(lambda r, d: jgae.discount(GAMMA, r, d,
                                                 use_pallas=False), shape)
    want_gae, want_disc = j_gae(r, d, v), j_disc(r, d)
    _close(want_gae, j_gae_xla(r, d, v))
    _close(want_disc, j_disc_xla(r, d))

    _close(gae_cuda.gae_plain(GAMMA, TAU, _t(r), _t(d), _t(v)), want_gae)
    _close(gae_cuda.discount_plain(GAMMA, _t(r), _t(d)), want_disc)
    _close(tgae.generalized_advantage(GAMMA, TAU, _t(r), _t(d), _t(v)),
           want_gae)
    _close(tgae.discount(GAMMA, _t(r), _t(d)), want_disc)


@pytest.mark.parametrize("layout", list(SHAPES))
def test_compute_advantages_matches_jax(layout):
    shape = SHAPES[layout]
    r, d, v = _inputs(shape, 1)
    nv = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    want = _jax(lambda r, d, v, nv: jgae.compute_advantages(
        TAU, GAMMA, r, d, v, nv), shape)(r, d, v, nv)
    got = tgae.compute_advantages(TAU, GAMMA, _t(r), _t(d), _t(v), _t(nv))
    _close(got, want)


@pytest.mark.parametrize("layout", list(SHAPES))
@pytest.mark.parametrize("scalar", [True, False])
def test_nonzero_bootstrap_takes_the_plain_path(layout, scalar):
    shape = SHAPES[layout]
    r, d, v = _inputs(shape, 3)
    tail = shape[:-2] + shape[-1:] if len(shape) > 1 else ()
    boot = (np.float32(0.5) if scalar else np.random.default_rng(4).normal(
        size=tail).astype(np.float32))
    want_d = _jax(lambda r, d, b: jgae.discount(GAMMA, r, d, b,
                                                use_pallas=False),
                  shape)(r, d, np.broadcast_to(boot, tail))
    want_g = _jax(lambda r, d, v, b: jgae.generalized_advantage(
        GAMMA, TAU, r, d, v, b, use_pallas=False),
        shape)(r, d, v, np.broadcast_to(boot, tail))
    b = 0.5 if scalar else _t(boot)
    gae_cuda.reset_launch_counts()
    _close(tgae.discount(GAMMA, _t(r), _t(d), bootstrap=b), want_d)
    _close(tgae.generalized_advantage(GAMMA, TAU, _t(r), _t(d), _t(v),
                                      next_value=b), want_g)
    assert gae_cuda.launch_counts() == {"gae_sweep": 0, "discount_sweep": 0}


@pytest.mark.parametrize("layout", list(SHAPES))
def test_gradients_match_jax_vjp(layout):
    shape = SHAPES[layout]
    r, d, v = _inputs(shape, 5)
    ct = jnp.asarray(np.random.default_rng(6).normal(size=shape),
                     jnp.float32)
    # the JAX kernels' custom_vjp reruns this XLA formulation (their
    # custom_vmap wrapper itself is not differentiable)
    _, vjp = jax.vjp(_jax(lambda r, d, v: jgae.generalized_advantage(
        GAMMA, TAU, r, d, v, 0.0, use_pallas=False), shape), r, d, v)
    want_r, _, want_v = vjp(ct)
    _, vjp = jax.vjp(_jax(lambda r, d: jgae.discount(
        GAMMA, r, d, use_pallas=False), shape), r, d)
    want_dr = vjp(ct)[0]

    tr, tv = _t(r).requires_grad_(), _t(v).requires_grad_()
    got_r, got_v = torch.autograd.grad(
        tgae.generalized_advantage(GAMMA, TAU, tr, _t(d), tv), (tr, tv),
        _t(ct))
    _close(got_r, want_r)
    _close(got_v, want_v)
    (got_dr,) = torch.autograd.grad(tgae.discount(GAMMA, tr, _t(d)), tr,
                                    _t(ct))
    _close(got_dr, want_dr)
    # the kernels' backward on the card: the VJP of the plain formulation
    got = gae_cuda._plain_vjp(
        lambda r, d, v: gae_cuda.gae_plain(GAMMA, TAU, r, d, v),
        (_t(r), _t(d), _t(v)), (True, False, True), _t(ct))
    assert got[1] is None
    _close(got[0], want_r)
    _close(got[2], want_v)


def test_cpu_path_launches_no_kernel_and_other_devices_raise():
    r, d, v = (_t(a) for a in _inputs((B, T, E), 7))
    gae_cuda.reset_launch_counts()
    gae_cuda.gae_sweep(GAMMA, TAU, r, d, v)
    gae_cuda.discount_sweep(GAMMA, r, d)
    assert gae_cuda.launch_counts() == {"gae_sweep": 0, "discount_sweep": 0}
    meta = [t.to("meta") for t in (r, d, v)]
    with pytest.raises(RuntimeError, match="unsupported device"):
        gae_cuda.gae_sweep(GAMMA, TAU, *meta)
    with pytest.raises(ValueError, match="one device"):
        gae_cuda.discount_sweep(GAMMA, r, meta[1])


def test_kernel_input_checks():
    r, d, v = (_t(a) for a in _inputs((B, T, E), 8))
    assert gae_cuda._check(r, d, v) == (B, T, E)
    assert gae_cuda._check(r[0], d[0]) == (1, T, E)
    assert gae_cuda._check(r[0, :, 0].contiguous(),
                           d[0, :, 0].contiguous()) == (1, T, 1)
    with pytest.raises(ValueError, match="float32"):
        gae_cuda._check(r.double(), d.double())
    with pytest.raises(ValueError, match="float32"):
        gae_cuda._check(r.transpose(1, 2), d.transpose(1, 2))
    with pytest.raises(ValueError, match="shapes differ"):
        gae_cuda._check(r, d[:1])
    with pytest.raises(ValueError, match=r"\[T\], \[T, E\] or \[B, T, E\]"):
        gae_cuda.sweep_view(r[None])
