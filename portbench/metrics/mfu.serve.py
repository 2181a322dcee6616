"""Model FLOPs of the work the untraced window completed (roofline.py's
count for the configuration's algorithm) over the window's time and the
H100's peak in the configuration's dtype, in per cent."""

from portbench.metrics._shared import mfu_pct

UNIT, SOURCE = "%", "host_clock"
LAYER = "the whole step: a served call or a meta-iteration"
MOVES = "serve_requests_per_s"


def read(ctx):
    return mfu_pct(ctx, ctx.driver.unit_flops(), ctx.driver.dtype())
