"""Device ms a meta-iteration inside the four blocks' plain double
backward: the port's ``cnn4_block_double_backward`` marks, captured into
the replayed iteration's twin inside autograd's backward, summed and
divided by the replays of the traced stretch (``_program_spans.py``)."""

from portbench.metrics._program_spans import device_ms_per_replay

UNIT, SOURCE = "ms", "device_trace"
LAYER = ("cuda/cnn4_cuda.py FusedBlockBackward.backward and adapt/maml.py "
         "on library kernels")
MOVES = "train_tasks_per_s"


def read(ctx):
    return device_ms_per_replay(ctx, "cnn4_block_double_backward")
