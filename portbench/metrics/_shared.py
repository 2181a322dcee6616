"""Helpers of the per-layer metric readers (not a metric: no entry of
``BENCHMARK.json`` names it)."""

from __future__ import annotations

from portbench import roofline
from portbench import trace as tracing

# kernels of the port's csrc/cnn4_block.cu and csrc/gae.cu, as the
# profiler names them (short names, trace.short_name)
CNN4_KERNELS = ("fwd_conv_stats_kernel", "fwd_combine_kernel",
                "fwd_norm_kernel", "bwd_input_kernel",
                "bwd_tile_sums_kernel", "bwd_combine_kernel",
                "bwd_dw_kernel", "bwd_dw_reduce_kernel",
                "fwd_conv_stats_tc_kernel", "bwd_dy_split_kernel",
                "bwd_dw_tc_kernel", "bwd_input_tc_kernel",
                "fwd_cluster_kernel", "bwd_params_cluster_kernel")
SWEEP_KERNELS = ("scan_kernel",)


def idle_pct(ctx):
    """100 x (1 - busy / span) of the traced stretch, both from its trace
    of the card alone: busy the union of the kernels' intervals, span from
    its first device record to its last."""
    tr = ctx.trace
    if tr is None or not tr.kernels or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tracing.busy_s(tr.kernels) / tr.window_s)


def mfu_pct(ctx, flops_per_unit: float, dtype: str):
    """Model FLOPs of the work the window completed over its time and the
    peak of the configuration's dtype, in per cent."""
    win = ctx.window
    if not win["units"] or win["seconds"] <= 0:
        return None
    rate = flops_per_unit * win["units"] / win["seconds"]
    return 100.0 * rate / roofline.PEAK_FLOPS[dtype]


def roofline_pct(ctx, bound_s_per_unit: float, names) -> float | None:
    """Least time of the traced stretch's work in these kernels over their
    device time there, in per cent."""
    tr = ctx.trace
    if tr is None or not ctx.profiled_units:
        return None
    busy = tracing.kernel_seconds(tr.kernels, names)
    if busy <= 0:
        return None
    return 100.0 * bound_s_per_unit * ctx.profiled_units / busy
