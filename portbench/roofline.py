"""The yardstick: published peaks of one NVIDIA H100 and the operations
and bytes that the work of the benchmark's models needs, as functions of
their shapes.

Each input is read once and each output written once; a count is of the
work a block operation needs, not of what the kernels that do it today
launch, so a kernel that is fused or replaced leaves it valid. The CNN4
block formulas are those of PERF.md's table of kernels (``chip_smoke.py``
``bound``); the backward's operations leave out the re-forward of the
conv output that ``bwd_params`` does today, so they stay a lower bound
for a kernel that keeps it instead.
"""

from __future__ import annotations

# H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BYTES = 3.35e12                 # HBM3 bytes/s
PEAK_FLOPS = {"float32": 67e12,      # outside the tensor cores
              "bfloat16": 989e12}    # tensor cores
ITEM = {"float32": 4, "bfloat16": 2}


def out_hw(h: int) -> int:
    """Output side of a 3x3 stride-2 conv with padding 1."""
    return (h - 1) // 2 + 1


def conv_macs(n: int, h: int, ci: int, co: int) -> int:
    """Multiply-adds of one image's stride-2 3x3 conv, in-range taps only."""
    ho = out_hw(h)
    rows = sum(1 for i in range(ho) for d in range(3)
               if 0 <= 2 * i + d - 1 < h)
    return n * rows * rows * ci * co


def cnn4_blocks(image: int, channels: int, hidden: int,
                layers: int) -> list:
    """``(h, ci)`` of each stride-2 block."""
    out, h, ci = [], image, channels
    for _ in range(layers):
        out.append((h, ci))
        h, ci = out_hw(h), hidden
    return out


def block_work(op: str, b: int, n: int, h: int, ci: int, co: int,
               dtype: str) -> tuple:
    """``(flops, bytes)`` of one block operation on ``b`` tasks of ``n``
    images: ``fwd`` (conv, batch-stat BN, ReLU), ``dw`` (the BN and ReLU
    backward and the conv's parameter gradients, dy written in f32) or
    ``dx`` (the conv's input gradient from the f32 dy)."""
    item = ITEM[dtype]
    ho = out_hw(h)
    xin, w = b * n * h * h * ci, b * 9 * ci * co
    out, pc = b * n * ho * ho * co, b * co
    macs = b * conv_macs(n, h, ci, co)
    if op == "fwd":
        return 2 * macs + 10 * out, item * (xin + w + 3 * pc + out)
    if op == "dw":
        return (2 * macs + 20 * out,
                item * (xin + w + 3 * pc + out) + 4 * out
                + item * (w + 3 * pc))
    if op == "dx":
        return 2 * macs, 4 * out + item * (w + xin)
    raise ValueError(op)


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time of work: the larger of its operations over the peak
    of its dtype and its bytes over the HBM peak."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def cnn4_pass(op: str, b: int, n: int, cfg: dict, dtype: str,
              first_block: bool = True) -> tuple:
    """``(flops, bound seconds)`` of ``op`` over every block of the CNN4 (a
    ``dx`` pass needs none at block 1, whose input is the images)."""
    flops = secs = 0.0
    blocks = cnn4_blocks(cfg["image_size"], cfg["channels"], cfg["hidden"],
                         cfg["layers"])
    for k, (h, ci) in enumerate(blocks):
        if op == "dx" and k == 0 and not first_block:
            continue
        f, nb = block_work(op, b, n, h, ci, cfg["hidden"], dtype)
        flops += f
        secs += bound_s(f, nb, dtype)
    return flops, secs


def cnn4_forward_flops(n: int, cfg: dict) -> float:
    """Model FLOPs of one CNN4 forward over ``n`` images: the convs and the
    head (BN and ReLU are counted with the convs in :func:`block_work`)."""
    flops, _ = cnn4_pass("fwd", 1, n, cfg, "float32")
    return flops + 2 * n * cfg["hidden"] * cfg["ways"]


def serve_request_flops(cfg: dict) -> float:
    """One served few-shot request: the support forward, the inner step's
    backward (dw at every block, dx at blocks 2 on) and the query forward
    with the adapted weights, ``adapt_steps`` times the first two."""
    s, q = cfg["ways"] * cfg["shots"], cfg["queries"]
    fwd_s = cnn4_forward_flops(s, cfg)
    bwd_s = (cnn4_pass("dw", 1, s, cfg, "float32")[0]
             + cnn4_pass("dx", 1, s, cfg, "float32", first_block=False)[0])
    return cfg["adapt_steps"] * (fwd_s + bwd_s) + cnn4_forward_flops(q, cfg)


def serve_request_kernel_bound(cfg: dict, dtype: str) -> float:
    """Least seconds of a served request's CNN4 block operations (as
    :func:`serve_request_flops`, at the served dtype)."""
    s, q = cfg["ways"] * cfg["shots"], cfg["queries"]
    secs = cnn4_pass("fwd", 1, q, cfg, dtype)[1]
    secs += cfg["adapt_steps"] * (
        cnn4_pass("fwd", 1, s, cfg, dtype)[1]
        + cnn4_pass("dw", 1, s, cfg, dtype)[1]
        + cnn4_pass("dx", 1, s, cfg, dtype, first_block=False)[1])
    return secs


def maml_task_flops(cfg: dict) -> float:
    """Model FLOPs of one task of second-order MAML with one inner step
    (support and query of ``ways * shots`` images each): the support
    forward F_s, the inner gradient (dw + dx, B_s), the query forward F_q
    and its backward B_q, the backward through the inner gradient (twice
    B_s: a double backward is the backward of a backward) and the support
    forward's backward (B_s)."""
    n = cfg["ways"] * cfg["shots"]
    f = cnn4_forward_flops(n, cfg)
    b = (cnn4_pass("dw", 1, n, cfg, "float32")[0]
         + cnn4_pass("dx", 1, n, cfg, "float32", first_block=False)[0])
    return 2 * f + 5 * b


def maml_iteration_kernel_bound(cfg: dict, tasks: int, dtype: str) -> float:
    """Least seconds of the CNN4 block operations of one second-order
    meta-step: the support and query forwards, the inner gradient, and the
    first-order parts of the outer backward through the query and the
    support passes (the second-order part runs outside the block
    operations)."""
    n = cfg["ways"] * cfg["shots"]
    fwd = cnn4_pass("fwd", tasks, n, cfg, dtype)[1]
    dw = cnn4_pass("dw", tasks, n, cfg, dtype)[1]
    dx = cnn4_pass("dx", tasks, n, cfg, dtype, first_block=False)[1]
    return 2 * fwd + 3 * dw + 3 * dx


def sweep_bound_s(kind: str, elements: int) -> float:
    """Least seconds of one GAE or discount sweep over ``elements`` f32
    steps: GAE reads rewards, dones and values and writes advantages;
    discounting reads rewards and dones and writes returns."""
    words = 4 if kind == "gae_sweep" else 3
    return 4 * words * elements / PEAK_BYTES


def mlp_flops(sizes: list, rows: int) -> float:
    """Forward FLOPs of an MLP of layer ``sizes`` over ``rows`` inputs."""
    return 2.0 * rows * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))


def vpg_request_flops(cfg: dict, episodes: int, horizon: int) -> float:
    """One served policy adaptation: the support log-probs' forward and
    backward (3F) for each inner step."""
    sizes = [cfg["obs_size"], *cfg["hiddens"], cfg["action_size"]]
    return 3 * mlp_flops(sizes, episodes * horizon) * cfg["adapt_steps"]
