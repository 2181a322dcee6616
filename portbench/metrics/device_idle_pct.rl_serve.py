"""Share of the traced stretch in which no kernel runs on the device:
1 - (the union of the kernels' intervals) / (the span from the first
device record to the last), both from the trace of the card alone."""

from portbench.metrics._shared import idle_pct

UNIT, SOURCE = "%", "device_trace"
LAYER = "device"
MOVES = "rl_serve_requests_per_s"


def read(ctx):
    return idle_pct(ctx)
