"""Device ms a meta-iteration during which a kernel that is not the
port's own runs (cuDNN, cuBLAS, layout transposes, elementwise: the plain
double backward, the losses and Adam): the union of their intervals, as
a replay may run kernels side by side, over the traced stretch."""

from portbench import trace as tracing
from portbench.metrics._shared import CNN4_KERNELS, SWEEP_KERNELS

UNIT, SOURCE = "ms", "device_trace"
LAYER = ("cuda/cnn4_cuda.py FusedBlockBackward.backward and adapt/maml.py "
         "on library kernels")
MOVES = "train_tasks_per_s"


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.profiled_units or not tr.kernels:
        return None
    own = set(CNN4_KERNELS) | set(SWEEP_KERNELS)
    lib = [s for s in tr.kernels if tracing.short_name(s.name) not in own]
    return 1e3 * tracing.busy_s(lib) / ctx.profiled_units
