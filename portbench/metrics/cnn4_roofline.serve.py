"""Share of the CNN4 block operations' least time (bytes over HBM
bandwidth or operations over the dtype's peak, roofline.py) in the device
time of the port's cnn4_block kernels, over the traced stretch."""

from portbench.metrics._shared import CNN4_KERNELS, roofline_pct

UNIT, SOURCE = "%", "device_trace"
LAYER = "cuda/cnn4_cuda.py -> csrc/cnn4_block.cu"
MOVES = "serve_requests_per_s"


def read(ctx):
    bound = ctx.driver.kernel_bound_s() / ctx.traffic["batch"]
    return roofline_pct(ctx, bound, CNN4_KERNELS)
