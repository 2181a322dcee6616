"""The yardstick's operation and byte counts on shapes worked by hand,
against the bounds of PERF.md's table of kernels (rows 3-6: B = 64, N =
25, and [20, 100, 20] sweeps)."""

import pytest

from portbench import roofline as r

CNN4 = {"image_size": 28, "channels": 1, "hidden": 64, "layers": 4,
        "ways": 5, "shots": 5, "queries": 15, "adapt_steps": 1}


def test_blocks_and_taps():
    assert r.cnn4_blocks(28, 1, 64, 4) == [(28, 1), (14, 64), (7, 64),
                                           (4, 64)]
    # 28 -> 14: output rows 0..13 see 3 taps but row 0, whose top tap is
    # padding: 14 * 3 - 1 = 41 in-range rows of taps, squared
    assert r.conv_macs(1, 28, 1, 64) == 41 * 41 * 64
    assert r.conv_macs(1, 4, 64, 64) == 5 * 5 * 64 * 64   # 4 -> 2: 2*3-1


def test_block_one_forward_by_hand():
    flops, nbytes = r.block_work("fwd", 64, 25, 28, 1, 64, "float32")
    out = 64 * 25 * 14 * 14 * 64
    assert flops == 2 * 64 * 25 * 41 * 41 * 64 + 10 * out
    assert nbytes == 4 * (64 * 25 * 28 * 28 + 64 * 9 * 64 + 3 * 64 * 64
                          + out)


@pytest.mark.parametrize("op,dtype,ms", [
    ("fwd", "float32", 0.130), ("fwd", "bfloat16", 0.0372),
    ("dw", "bfloat16", 0.0739), ("dx", "float32", 0.103),
    ("dx", "bfloat16", 0.0286)])
def test_four_blocks_match_perf_table(op, dtype, ms):
    _, secs = r.cnn4_pass(op, 64, 25, CNN4, dtype, first_block=op != "dx")
    assert secs * 1e3 == pytest.approx(ms, rel=5e-3)


def test_dw_leaves_out_the_reforward():
    # PERF.md's 0.257 ms (f32) counts the conv's re-forward (4 MACs a
    # tap); the yardstick counts dw's 2, so it bounds a kernel that keeps y
    _, secs = r.cnn4_pass("dw", 64, 25, CNN4, "float32")
    assert secs * 1e3 == pytest.approx(0.1579, rel=5e-3)
    assert secs * 1e3 < 0.257


@pytest.mark.parametrize("kind,ms", [("gae_sweep", 0.000191),
                                     ("discount_sweep", 0.000143)])
def test_sweeps_match_perf_table(kind, ms):
    assert r.sweep_bound_s(kind, 20 * 100 * 20) * 1e3 == pytest.approx(
        ms, rel=5e-3)


def test_model_flops_of_a_request_and_a_task():
    fwd25 = r.cnn4_forward_flops(25, CNN4)
    # in-range tap rows of the four blocks: 41, 20, 10 and 5
    assert fwd25 == pytest.approx(25 * (2 * (41 * 41 * 64 + 20 * 20 * 64
                                             * 64 + 10 * 10 * 64 * 64
                                             + 5 * 5 * 64 * 64)
                                        + 10 * 64 * (196 + 49 + 16 + 4))
                                  + 2 * 25 * 64 * 5)
    assert r.serve_request_flops(CNN4) == pytest.approx(0.4163e9, rel=1e-3)
    assert r.maml_task_flops(CNN4) == pytest.approx(1.379e9, rel=1e-3)


def test_mlp_and_vpg_counts():
    assert r.mlp_flops([2, 100, 100, 2], 1) == 2 * (200 + 10000 + 200)
    cfg = {"obs_size": 2, "hiddens": [100, 100], "action_size": 2,
           "adapt_steps": 1}
    assert r.vpg_request_flops(cfg, 10, 50) == 3 * 500 * 20800


def test_bound_is_the_larger_of_bytes_and_operations():
    assert r.bound_s(67e12, 0, "float32") == pytest.approx(1.0)
    assert r.bound_s(0, 3.35e12, "bfloat16") == pytest.approx(1.0)
    assert r.bound_s(989e12, 3.35e12 / 2, "bfloat16") == pytest.approx(1.0)
