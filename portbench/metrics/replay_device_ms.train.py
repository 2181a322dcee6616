"""Device ms of one replay (a meta-iteration), from the mark its graph stamps first
to the one it stamps last (the port's ``graphs.replay`` marks, captured
into the instrumented twin), mean over the traced stretch
(``_program_spans.py``)."""

from portbench.metrics._program_spans import replay_device_ms

UNIT, SOURCE = "ms", "device_trace"
LAYER = "the whole step: a served call or a meta-iteration"
MOVES = "train_tasks_per_s"


def read(ctx):
    return replay_device_ms(ctx)
