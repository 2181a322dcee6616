"""Host ms a served call spends in the port's ``graphs.clone_out`` span:
the clones of the graph's outputs handed to the caller, in the traced
stretch (``_program_spans.py``)."""

from portbench.metrics._program_spans import host_ms_per_call

UNIT, SOURCE = "ms", "host_clock"
LAYER = "serve.py servers over utils/graphs.py CapturedCalls"
MOVES = "rl_serve_requests_per_s"


def read(ctx):
    return host_ms_per_call(ctx, "graphs.clone_out")
