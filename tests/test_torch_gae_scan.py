"""The sweep kernels' decomposition (``gae_cuda.scan_plain``) vs JAX.

``csrc/gae.cu`` computes both sweeps as a segmented affine scan over
time: slabs of ``seg * segments`` steps from the end of time, per-segment
maps, their combine by a doubling suffix scan, and a replay of each
segment. ``scan_plain`` is that decomposition in PyTorch, with the slab
shape as parameters. Here it is held against the JAX Pallas kernels
(``gae_pallas`` / ``discount_pallas``, in interpret mode on the CPU) and
against JAX ``ops.gae`` with ``use_pallas=False``, on the same numpy
inputs, at ``[T]``, ``[T, E]`` and ``[B, T, E]`` (JAX under ``vmap``),
with dones mid-column, all zero and all one, and at ragged T: T = 1, T
below the number of segments, T not a multiple of the segment, and T one
past a slab, for the kernel's own slabs (32 segments of 4 steps up to T =
128, of 8 past it) and two small ones.

Tolerance: ``1e-6 * max|want| * max(1, T / 40)``. Both sides round each
of the up to T terms of an output once in float32 (2^-24 relative), in
different orders; 1e-6 covers T <= 40 (as ``tests/test_torch_gae.py`` at
T = 12), and the bound on the accumulated rounding grows linearly in T.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from exploring_meta_tpu.ops import gae as jgae
from exploring_meta_tpu.pallas import discount_pallas, gae_pallas
from exploring_meta_tpu_torch.cuda import build, gae_cuda

GAMMA, TAU = 0.99, 0.95
E, B = 3, 2
# (steps a segment, segments a slab): the kernel's (None: the segment it
# takes for T, 4 steps up to T = 128, 8 past it), both of its segments at
# every T, and two small slabs (8 and 15 steps) whose edges the ragged T
# below fall on
SCHEMES = [(None, gae_cuda.SEGMENTS), (gae_cuda.SEG_SHORT, gae_cuda.SEGMENTS),
           (gae_cuda.SEG_LONG, gae_cuda.SEGMENTS), (2, 4), (3, 5)]
# 1; below the segments of the small slabs (3); not a multiple of the
# segment (7); one past a small slab (9, 16); one past the kernel's short
# slab (129, where it takes the long segment); one past its long slab (257)
LENGTHS = [1, 3, 7, 9, 16, 129, 257]
DONES = ["mid", "zeros", "ones"]


def _dones(rng, shape, kind):
    if kind == "mid":
        return (rng.uniform(size=shape) < 0.2).astype(np.float32)
    return np.full(shape, float(kind == "ones"), np.float32)


def _inputs(shape, seed, kind=None):
    """r, d, V from a seed. With no ``kind``, the last axis holds one
    column of each kind of dones (mid, all zero, all one)."""
    rng = np.random.default_rng(seed)
    r = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    if kind is not None:
        d = _dones(rng, shape, kind)
    else:
        d = np.stack([_dones(rng, shape[:-1], k) for k in DONES], axis=-1)
    return r, d, v


def _close(got, want, T):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=0, atol=1e-6 * np.abs(want).max() * max(1, T / 40))


def _jax(fn, shape):
    """Run a single-trajectory JAX fn, under vmap for a task batch."""
    return jax.vmap(fn) if len(shape) == 3 else fn


def _sweeps(r, d, v):
    """GAE and the discount by the Pallas kernels and by the XLA scans."""
    return (gae_pallas(GAMMA, TAU, r, d, v),
            jgae.generalized_advantage(GAMMA, TAU, r, d, v, 0.0,
                                       use_pallas=False),
            discount_pallas(GAMMA, r, d),
            jgae.discount(GAMMA, r, d, use_pallas=False))


def _check_against_jax(shape, r, d, v):
    T = shape[1] if len(shape) == 3 else shape[0]
    # one jit of the four: compiling them together is the test's cost
    pallas_gae, xla_gae, pallas_disc, xla_disc = jax.jit(
        _jax(_sweeps, shape))(r, d, v)
    tr, td, tv = (torch.as_tensor(a) for a in (r, d, v))
    for seg, segments in SCHEMES:
        got_gae = gae_cuda.scan_plain(GAMMA, TAU, tr, td, tv, seg=seg,
                                      segments=segments)
        got_disc = gae_cuda.scan_plain(GAMMA, None, tr, td, seg=seg,
                                       segments=segments)
        for got, want in ((got_gae, pallas_gae), (got_gae, xla_gae),
                          (got_disc, pallas_disc), (got_disc, xla_disc)):
            _close(got, want, T)


@pytest.mark.parametrize("T", LENGTHS)
@pytest.mark.parametrize("dones", DONES)
def test_scan_matches_jax_single_column(T, dones):
    shape = (T,)
    _check_against_jax(shape, *_inputs(shape, T, dones))


@pytest.mark.parametrize("T", LENGTHS)
@pytest.mark.parametrize("layout", ["TE", "BTE"])
def test_scan_matches_jax_lanes(T, layout):
    """Lanes with dones mid, all zero and all one side by side."""
    shape = (T, E) if layout == "TE" else (B, T, E)
    _check_against_jax(shape, *_inputs(shape, 100 + T))


@pytest.mark.parametrize("shape", [(20, 100, 20), (40, 150, 20), (100, 400),
                                   (100,), (1,), (4, 129, 5), (1000,)])
def test_scan_equals_the_sequential_twins_in_float64(shape):
    """At the shapes chip_smoke.py runs the kernels, the decomposition is
    the sequential recurrence up to float64 rounding."""
    r, d, v = (torch.as_tensor(a, dtype=torch.float64)
               for a in _inputs(shape, 7, "mid"))
    for got, want in (
            (gae_cuda.scan_plain(GAMMA, TAU, r, d, v),
             gae_cuda.gae_plain(GAMMA, TAU, r, d, v)),
            (gae_cuda.scan_plain(GAMMA, None, r, d),
             gae_cuda.discount_plain(GAMMA, r, d))):
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-12 * float(
            want.abs().max())


def test_constants_mirror_the_source():
    with open(os.path.join(build.CSRC, "gae.cu")) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kSegShort") == gae_cuda.SEG_SHORT
    assert const("kSegLong") == gae_cuda.SEG_LONG
    assert const("kLanes") == gae_cuda.LANES
    assert "constexpr int kSlab = 32 * kSeg;" in src
    assert "if (T <= 32 * kSegShort) {" in src
    assert gae_cuda.SEGMENTS == 32
    assert [gae_cuda.segment_steps(T) for T in (1, 128, 129, 1000)] == [
        4, 4, 8, 8]
