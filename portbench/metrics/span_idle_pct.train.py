"""Share of the traced stretch's host wall in which the device runs no
replay: 1 - (the union of the replays' device intervals, from the port's
``graphs.replay`` marks) / (the wall around the stretch), with no
profiler running (``_program_spans.py``)."""

from portbench.metrics._program_spans import span_idle_pct

UNIT, SOURCE = "%", "device_trace"
LAYER = "device"
MOVES = "train_tasks_per_s"


def read(ctx):
    return span_idle_pct(ctx)
