"""The analysis tier's ops and probe helpers of the PyTorch port against the
JAX package, on the CPU, on identical numpy inputs.

Tolerances: ``calc_cl_metrics`` is the same float64 numpy on both sides,
held at 1e-12. SVCCA: both sides take a float32 covariance (``jnp.cov`` /
``torch.cov``, differing only in summation order) and the same float64
decompositions, so the coefficients are held at 1e-5 absolute (they lie
in [0, 1]); where the datapoints do not outnumber the neurons of both
sets together (the square tie's ``(k - 1, k)`` reps), the stacked
covariance is singular, the coefficients exceed 1 by ~1e-4 and carry
float32 rounding amplified by the pseudo-inverse, in JAX as here: held at
1e-3. CKA: float32 Gram products on both sides, 1e-5 absolute.
``_per_state_similarity`` is float64 numpy on both sides, 1e-12.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploring_meta_tpu.analysis import rc as jrc
from exploring_meta_tpu.models import cnn4 as jcnn
from exploring_meta_tpu.ops import cca as jcca
from exploring_meta_tpu.ops import cka as jcka
from exploring_meta_tpu.ops.cl_metrics import calc_cl_metrics as jcl_metrics
from exploring_meta_tpu.rl.rollout import Trajectory as JTrajectory
from exploring_meta_tpu_torch.analysis import rc as trc
from exploring_meta_tpu_torch.envs.particles2d import Particles2D
from exploring_meta_tpu_torch.models import cnn4 as tcnn
from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
from exploring_meta_tpu_torch.ops import cca as tcca
from exploring_meta_tpu_torch.ops import cka as tcka
from exploring_meta_tpu_torch.ops.cl_metrics import calc_cl_metrics
from exploring_meta_tpu_torch.rl.rollout import make_rollout
from exploring_meta_tpu_torch.utils.bridge import params_to_numpy

CCA_TOL, CCA_SINGULAR_TOL, CKA_TOL = 1e-5, 1e-3, 1e-5


@pytest.mark.parametrize("n,seed", [(2, 0), (4, 1), (7, 2), (10, 3)])
def test_calc_cl_metrics_matches_jax(n, seed):
    acc = np.random.default_rng(seed).uniform(size=(n, n))
    want = jcl_metrics(acc)
    got = calc_cl_metrics(acc)
    assert set(got) == set(want) == {"av_acc", "fwt", "rem", "bwt_plus"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k


def _random_acts(key, nx, ny, m, correlated=False):
    """The inputs of tests/test_cca_oracle.py."""
    rng = np.random.default_rng(key)
    a1 = rng.standard_normal((nx, m))
    if correlated:
        mix = rng.standard_normal((ny, nx))
        a2 = mix @ a1 + 0.05 * rng.standard_normal((ny, m))
    else:
        a2 = rng.standard_normal((ny, m))
    return a1, a2


@pytest.mark.parametrize("nx,ny,m,correlated,epsilon", [
    (10, 10, 64, False, 1e-10),
    (10, 10, 64, True, 1e-10),
    (8, 14, 50, True, 1e-10),   # different neuron counts
    (20, 20, 200, True, 1e-6),  # the robust_cca epsilon
    (6, 6, 40, False, 0.0),     # reference default epsilon
])
def test_cca_matches_jax(nx, ny, m, correlated, epsilon):
    a1, a2 = _random_acts(nx * 1000 + ny, nx, ny, m, correlated)
    want_info, want = jcca.get_cca_similarity(a1, a2, epsilon=epsilon)
    info, got = tcca.get_cca_similarity(a1, a2, epsilon=epsilon)
    assert abs(got - want) <= CCA_TOL
    np.testing.assert_allclose(info["cca_coef1"], want_info["cca_coef1"],
                               rtol=0, atol=CCA_TOL)
    for k in ("mean", "sum"):
        np.testing.assert_allclose(info[k], want_info[k], rtol=0,
                                   atol=CCA_TOL * max(nx, ny))
    np.testing.assert_array_equal(info["x_idxs"], want_info["x_idxs"])
    np.testing.assert_array_equal(info["y_idxs"], want_info["y_idxs"])
    # torch tensors in, the same numbers out
    _, from_tensors = tcca.get_cca_similarity(torch.from_numpy(a1),
                                              torch.from_numpy(a2),
                                              epsilon=epsilon)
    assert from_tensors == got


def test_cca_orientation_and_robust_retry_match_jax():
    with pytest.raises(AssertionError):
        tcca.get_cca_similarity(np.ones((64, 10)), np.ones((64, 10)))
    with pytest.raises(AssertionError):
        jcca.get_cca_similarity(np.ones((64, 10)), np.ones((64, 10)))
    a1, a2 = _random_acts(5, 8, 8, 48, correlated=True)
    _, want = jcca.robust_cca_similarity(a1, a2)
    _, got = tcca.robust_cca_similarity(a1, a2)
    assert abs(got - want) <= CCA_TOL


def test_numpy_median_is_not_torch_nanmedian():
    v = torch.tensor([1.0, 2.0, 3.0, 4.0])
    assert float(torch.nanmedian(v)) == 2.0       # the lower middle value
    assert float(tcka.numpy_median(v)) == 2.5 == np.median(v.numpy())
    rng = np.random.default_rng(0)
    for n in (1, 2, 5, 6, 101, 1000):
        x = rng.standard_normal(n).astype(np.float32)
        assert float(tcka.numpy_median(torch.from_numpy(x))) == \
            pytest.approx(float(np.median(x)), abs=1e-7)
    assert tcka.numpy_median(torch.zeros(0)) is None


@pytest.mark.parametrize("n,d", [(12, 5), (9, 30), (40, 16)])
def test_cka_matches_jax_at_an_even_count_of_distances(n, d):
    rng = np.random.default_rng(n * 100 + d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (x @ rng.standard_normal((d, d)) + 0.3 * rng.standard_normal(
        (n, d))).astype(np.float32)
    # the bandwidth's median runs over an even count of nonzero squared
    # distances (the matrix is symmetric), where torch.nanmedian would
    # take the lower middle value instead of numpy's mean of the two
    gx = x.astype(np.float64) @ x.T.astype(np.float64)
    sq = np.diag(gx)[:, None] + np.diag(gx)[None, :] - 2 * gx
    nz = torch.from_numpy(sq[sq > 1e-9])
    assert nz.numel() % 2 == 0
    assert float(torch.nanmedian(nz)) != pytest.approx(float(np.median(nz)))
    for want, got in (
            (jcka.get_linear_CKA(x, y), tcka.get_linear_CKA(x, y)),
            (jcka.get_kernel_CKA(x, y), tcka.get_kernel_CKA(x, y)),
            (jcka.get_kernel_CKA(x, y, sigma=2.0),
             tcka.get_kernel_CKA(x, y, sigma=2.0)),
            (jcka.get_kernel_CKA(x, x), tcka.get_kernel_CKA(x, x))):
        assert abs(float(got) - float(want)) <= CKA_TOL
    # the kernel CKA moves with the bandwidth, so the median matters
    lower = torch.nanmedian(nz).item()
    assert abs(float(tcka.get_kernel_CKA(x, y, sigma=lower ** 0.5))
               - float(jcka.get_kernel_CKA(x, y))) > CKA_TOL


@pytest.mark.parametrize("shape", [(8, 8), (40, 40), (6, 20), (30, 7)])
def test_similarities_match_jax(shape):
    """Square activations drop one datapoint (for CKA too: CKA on the 8
    rows differs by far more than its tolerance); the smaller axis goes
    first into CCA."""
    rng = np.random.default_rng(shape[0] * 10 + shape[1])
    init = rng.standard_normal(shape).astype(np.float32)
    adapted = (init + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    compare = ("cca", "cka_linear", "cka_kernel")
    want = jrc._similarities(init, adapted, compare)
    got = trc._similarities(torch.from_numpy(init), torch.from_numpy(adapted),
                            compare)
    assert set(got) == set(want)
    assert abs(got["cca"] - want["cca"]) <= (
        CCA_SINGULAR_TOL if shape[0] == shape[1] else CCA_TOL)
    for k in ("cka_linear", "cka_kernel"):
        assert abs(got[k] - want[k]) <= CKA_TOL, k


def test_per_state_similarity_matches_jax():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((70, 12)).astype(np.float32)
    b = (a + 0.5 * rng.standard_normal((70, 12))).astype(np.float32)
    a[3] = 1.0                                  # a constant state: skipped
    for kw in ({}, {"max_states": 5}):
        want = jrc._per_state_similarity(a, b, **kw)
        got = trc._per_state_similarity(torch.from_numpy(a),
                                        torch.from_numpy(b), **kw)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    const = np.ones((4, 6), np.float32)
    assert trc._per_state_similarity(const, const) == \
        jrc._per_state_similarity(const, const) == (1.0, 0.0)


@pytest.fixture(scope="module")
def probe_traj():
    """One Particles2D task's rollout in which some episodes end early (a
    coarse goal threshold), so real_states has filler to drop."""
    env = Particles2D(goal_threshold=0.2)
    policy = DiagNormalPolicy(2, 2, hiddens=(16, 16))
    gen = torch.Generator().manual_seed(3)
    params = policy.init(gen, device="cpu")
    traj = make_rollout(env, policy.sample, 6, 20)(
        params, torch.tensor([0.3, -0.25]), gen)
    return traj


def test_real_states_match_jax(probe_traj):
    got = trc.real_states(probe_traj)
    jtraj = JTrajectory(*(jnp.asarray(x.numpy()) for x in probe_traj))
    want = jrc.real_states(jtraj)
    assert float(probe_traj.valid.min()) == 0.0    # filler exists
    assert 0 < got.shape[0] < probe_traj.valid.numel()
    assert len(set(map(tuple, got.tolist()))) > 1
    np.testing.assert_array_equal(got.numpy(), want)


def test_measure_change_through_time_matches_jax(tmp_path):
    """Three CNN4 checkpoints' pooled features of 40 images, (8, 40) into
    CCA. (``eval_rl`` feeds it policy reps of 2-D states, whose stacked
    covariance is rank-deficient: there two float32 covariances, JAX's
    included, differ by up to ~1e-2.)"""
    tspec, jspec = tcnn.omniglot_spec(5, hidden=8), jcnn.omniglot_spec(
        5, hidden=8)
    ckpts = [tcnn.init_cnn4(torch.Generator().manual_seed(s), tspec,
                            device="cpu") for s in (0, 1, 2)]
    x = np.random.default_rng(0).uniform(size=(40, 28, 28, 1)).astype(
        np.float32)
    os.makedirs(tmp_path / "t")
    os.makedirs(tmp_path / "j")
    got = trc.measure_change_through_time(
        str(tmp_path / "t"), ckpts,
        lambda p, v: tcnn.cnn4_features(p, tspec, v), torch.from_numpy(x))
    want = jrc.measure_change_through_time(
        str(tmp_path / "j"), [params_to_numpy(p) for p in ckpts],
        lambda p, v: jcnn.cnn4_features(p, jspec, v), x)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=0, atol=CCA_TOL)
    with open(tmp_path / "t" / "cca_through_time.json") as f:
        assert json.load(f) == got


def test_sanity_check_is_bit_exact(probe_traj):
    states = trc.real_states(probe_traj)
    policy = DiagNormalPolicy(2, 2)
    params = policy.init(torch.Generator().manual_seed(0), device="cpu")
    trc.sanity_check(policy.get_representation, params, states)
    with pytest.raises(AssertionError, match="not deterministic"):
        trc.sanity_check(lambda p, x: x + torch.rand(x.shape), None, states)
