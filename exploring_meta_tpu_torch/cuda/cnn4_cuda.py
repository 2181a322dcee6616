"""Fused CNN4-Omniglot block: CUDA kernels, their plain twins, autograd.

Port of ``exploring_meta_tpu/pallas/cnn4_pallas.py`` (rows 1-4 of the
TPU-kernel table in PERF.md). One block is zero-pad -> 3x3 stride-2 conv
+ bias -> batch-stat BN over (N, H, W) per channel and task -> scale/bias
-> ReLU. Four entry points in ``csrc/cnn4_block.cu`` compute it and its
derivatives:

- ``cnn4_block_fwd``        the block forward (``_blk_fwd_kernel``): a
  tiled implicit GEMM with per-tile BN statistics, their combine in tile
  order, then the normalisation (three launches);
- ``cnn4_block_bwd_params`` dy, dw, db, dscale, dbias (``_block_bwd`` and
  the dw/db half of ``_conv_s2_bwd``): the forward's conv and statistics
  recomputed, per-tile BN-backward sums and their combine in tile order,
  then dw as an implicit GEMM whose reduction over the positions is split
  into chunks, summed in chunk order (five or six launches; six or seven
  in bfloat16, where dy and its three bf16 terms are formed by a launch
  of their own);
- ``cnn4_block_bwd_input``  dx, the transposed stride-2 conv as four
  parity-class GEMMs;
- ``cnn4_block_double_bwd`` the VJP of that backward (second-order MAML,
  :class:`FusedBlockBackward`; no TPU kernel: JAX takes it as plain XLA),
  analytic, as three implicit GEMMs each over two pairs of operands (the
  re-forward and dy's cotangent; x's; w's) around the BN step's sums,
  constants and elementwise pass (six to eight launches, f32 products
  and sums on the CUDA cores in either dtype).

At one task a call (B = 1: ``VisionServer.__call__``, the vision
baseline's Adam steps, the CL analysis) the forward and ``bwd_params``
take one launch a block instead where :func:`cluster_plan` says the
cluster is faster than the tiled launches: ``fwd_cluster_kernel`` where
Ci % 64 == 0 and a CTA owns one tile of 64 positions (blocks 2-4 at N <=
15, blocks 3-4 at N = 25), ``bwd_params_cluster_kernel`` at block 1 (Ci
= 1) where a CTA owns at most 3 tiles (N <= 15). A thread-block cluster
of up to 16 CTAs holds the task's f32 conv output in shared memory and
combines its BN statistics, BN-backward sums and dw partials over
distributed shared memory, in rank order (the port of the single-task
TPU kernels, which hold the task in VMEM). The wrappers take the route
from the built source (:func:`source_cluster_plan`), which decides it for
the launch too; :func:`cluster_plan` is its mirror for the CPU.
:func:`block_fwd_cluster_plain` and :func:`block_bwd_params_cluster_plain`
emulate the kernels' summation order; :func:`routes` counts the calls by
route.

Every tensor has a leading task axis B (the JAX single-task form is
B = 1): x ``[B, N, H, W, Ci]`` NHWC, w ``[B, 3, 3, Ci, Co]`` HWIO,
b/scale/bias ``[B, Co]``, all of one dtype (float32 or bfloat16; math in
float32, outputs in that dtype). float32 computes on the CUDA cores (no
TF32, as the reference's ``Precision.HIGHEST``). bfloat16's conv, dw and
dx products run on the tensor cores (``mma.sync`` m16n8k16, f32
accumulation); dw's and dx's f32 operand dy goes in as three bf16 terms
whose sum is dy (:func:`split3_bf16`), so all three carry float32
products, as JAX's kernel does after upcasting its bf16 inputs
(:func:`dw_split3_plain` and :func:`dx_split3_plain` emulate that
arithmetic).

Each wrapper (:func:`block_fwd`, :func:`block_bwd_params`,
:func:`block_bwd_input`, :func:`block_double_bwd`) runs the plain PyTorch
twin for CPU tensors and launches its kernels for CUDA tensors; there is
no other path. Each counts the calls that launch its kernels in
``<wrapper>.launches`` (a call recorded into a CUDA graph in
``<wrapper>.captured``) and launches them inside a span of the kernel's
name (``utils/profiling.py:span``: a profiler range while a profiler
records), on the CPU too, so that a trace attributes their time to it.
The double backward's span also marks the device, so its time shows
inside a replayed, traced iteration.

Beside the twins stand plain versions of the kernels' decompositions
(:func:`tile_stats_plain`, :func:`combine_tile_stats_plain`,
:func:`bwd_tile_sums_plain`, :func:`combine_bwd_sums_plain`,
:func:`bwd_dy_plain`, :func:`dw_split_plain`, :func:`split3_bf16`,
:func:`dw_split3_plain`, :func:`parity_classes`,
:func:`block_bwd_input_parity_plain`, :func:`dx_split3_plain`), which the
tests hold against the JAX package; :func:`bf16_agreement` and
:func:`bf16_share_holds`, the bf16 kernels' check against a twin taken in
float64 (``acc``), with :func:`rounded_dy_share` and
:func:`rounded_dy_dx_share`, what that check gives a dy rounded to one
bf16;
and :func:`block_inputs`, random inputs for such checks on the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from exploring_meta_tpu_torch.utils.graphs import count_launch
from exploring_meta_tpu_torch.utils.profiling import span

EPS = 1e-5
_TILE_M = 64              # kTileM: positions (or dw rows) per CTA
_TILE_N = 64              # kTileN: channels per CTA
_TILE_K = 16              # kTileK: positions per stage of the dw GEMM
_TC_K = 32                # kTcK: channels co per stage of the bf16 dx GEMMs
_DW_CTAS = 4 * 132        # kDwCtas: CTAs the dw grid aims at
_DW_MIN_CHUNK = 256       # kDwMinChunk: fewest positions in a dw chunk
# the cluster route (mirrors cluster_plan in the source)
_CLUSTER_MAX = 16         # kClusterMax: CTAs a cluster where schedulable
_FWD_TILES_MAX = 1        # kFwdTilesMax: the forward's tiles a CTA at most
_BWD_TILES_MAX = 3        # kBwdTilesMax: bwd_params' (block 1)
_CLUSTER_SMEM_MAX = 232448  # kClusterSmemMax: 227 KB a CTA
_LD_C = _TILE_N + 4       # kLdC: a row of y in shared memory, floats
_TILE_Y_BYTES = _TILE_M * _LD_C * 4   # kTileYBytes
_AUX_BYTES = 11 * _TILE_N * 4         # kAuxBytes
_PART_BYTES = 9 * _LD_C * 4           # kPartBytes: block 1's dw partial
_TC_STAGE = _TILE_M * (_TC_K + 8) + _TC_K * (_TILE_N + 8)   # kTcStage, bf16
_F32_STAGE = (_TILE_M + _TILE_N) * (_TILE_K + 4)            # kStage, floats
_CW = 64                  # kCW: channels a fat stage of the forward
# the ring a CTA: (dtype, fat) -> bytes. Fat (the forward, Ci % 64 == 0):
# bf16 3 stages of 2 x 64 x 72 halves, f32 2 stages of 64 x 68 + 64 x 64
# floats. Else (bwd_params at block 1) the tiled path's stages, two deep.
_RING_BYTES = {
    (torch.bfloat16, True): 2 * 3 * 2 * _TILE_M * (_CW + 8),
    (torch.bfloat16, False): 2 * 2 * _TC_STAGE,
    (torch.float32, True): 4 * 2 * (_TILE_M * (_CW + 4) + _CW * _TILE_N),
    (torch.float32, False): 4 * 2 * _F32_STAGE}
MAX_TASKS = 65535         # the task axis is gridDim.y or .z of every kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "cnn4_block.cu"
_lib = None


def out_hw(h: int) -> int:
    """Output extent of a 3x3, stride-2, pad-1 conv."""
    return (h - 1) // 2 + 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def fwd_workspace_floats(b: int, n: int, h: int, w: int, co: int,
                         dtype: torch.dtype) -> int:
    """f32 scratch of ``cnn4_block_fwd`` (mirrors ``launch_fwd``): the
    per-tile (mean, M2) and per-task (mean, inv_std) of every channel, and
    y between the kernels where the output (bf16) cannot hold it."""
    m = n * out_hw(h) * out_hw(w)
    y = 0 if dtype == torch.float32 else b * m * co
    return 2 * b * _cdiv(m, _TILE_M) * co + 2 * b * co + y


def dw_chunk(b: int, m: int, ci: int, co: int) -> int:
    """Positions per chunk of the dw GEMM's split reduction (mirrors
    ``dw_chunk`` in the source): enough chunks that the grid holds about
    ``_DW_CTAS`` CTAs, none under ``_DW_MIN_CHUNK`` positions, a whole
    number of stages."""
    tiles = b * _cdiv(9 * ci, _TILE_M) * _cdiv(co, _TILE_N)
    want = max(1, min(_cdiv(_DW_CTAS, tiles), _cdiv(m, _DW_MIN_CHUNK)))
    return _cdiv(_cdiv(m, want), _TILE_K) * _TILE_K


class ClusterPlan(NamedTuple):
    """One cluster of ``size`` CTAs, each with ``smem`` bytes of dynamic
    shared memory."""
    size: int
    smem: int


def cluster_plan(b: int, n: int, h: int, w: int, ci: int, co: int,
                 dtype: torch.dtype, kernel: str = "cnn4_block_fwd",
                 max_size: int = _CLUSTER_MAX):
    """The route of one call of ``kernel`` (``cnn4_block_fwd`` or
    ``cnn4_block_bwd_params``), mirroring ``cluster_plan`` in the source:
    a :class:`ClusterPlan` on clusters of at most ``max_size`` CTAs (the
    device's, :func:`source_cluster_max`) where ``b`` == 1, 0 < Co <= 64
    with Co % 8 == 0, and for the forward Ci % 64 == 0 and one tile of 64
    positions a CTA, for ``bwd_params`` Ci == 1 and at most 3 tiles a CTA
    (:func:`cluster_rows`); else None (the tiled kernels). The CTA's
    shared memory: the ring, 2816 bytes that peers read, the position table
    (8 bytes a position), y (64 x 68 floats a tile); for ``bwd_params`` x
    of the images its positions can read (ceil(tiles 64 / (Ho Wo)) + 1 of
    them, at most N) and w, copied, and dw's partial (9 x 68 floats);
    within 227 KB."""
    m = n * out_hw(h) * out_hw(w)
    bwd = kernel == "cnn4_block_bwd_params"
    if (b != 1 or m == 0 or co > _TILE_N or co % 8
            or not (ci == 1 if bwd else ci % _CW == 0)):
        return None
    size = cluster_size(m, max_size)
    tiles = _cdiv(_cdiv(m, _TILE_M), size)
    if tiles > (_BWD_TILES_MAX if bwd else _FWD_TILES_MAX):
        return None
    smem = (_RING_BYTES[dtype, not bwd] + _AUX_BYTES + tiles * _TILE_M * 8
            + tiles * _TILE_Y_BYTES)
    if bwd:
        item = 2 if dtype == torch.bfloat16 else 4
        images = min(n, _cdiv(tiles * _TILE_M, out_hw(h) * out_hw(w)) + 1)
        smem += (_round16(images * h * w * ci * item)
                 + _round16(9 * ci * co * item) + _PART_BYTES)
    return ClusterPlan(size, smem) if smem <= _CLUSTER_SMEM_MAX else None


def _round16(n: int) -> int:
    return _cdiv(n, 16) * 16


def cluster_rows(m: int, size: int) -> list:
    """[(first, end)] positions of each rank of a cluster of ``size`` CTAs
    over a task's ``m`` positions: ceil(tiles / size) tiles of 64 a rank."""
    per = _cdiv(_cdiv(m, _TILE_M), size) * _TILE_M
    return [(min(m, q * per), min(m, (q + 1) * per)) for q in range(size)]


def bwd_params_workspace_floats(b: int, n: int, h: int, w: int, ci: int,
                                co: int,
                                dtype: torch.dtype = torch.float32) -> int:
    """f32 scratch of ``cnn4_block_bwd_params`` (mirrors
    ``launch_bwd_params``): the tile statistics, later the tile sums, and
    per (task, channel) the statistics and dy's constants, all as pairs; y
    ``[B, M, Co]``; the dw partials ``[B, chunks, 9 Ci Co + Co]`` where
    the positions are split into more than one chunk; in bfloat16, dy's
    three bf16 terms ``[3, B, M, Co]`` for the tensor cores' dw."""
    m = n * out_hw(h) * out_hw(w)
    if m == 0:
        return 0
    chunks = _cdiv(m, dw_chunk(b, m, ci, co))
    part = b * chunks * (9 * ci * co + co) if chunks > 1 else 0
    terms = 0 if dtype == torch.float32 else _cdiv(3 * b * m * co, 2)
    return (2 * b * _cdiv(m, _TILE_M) * co + 4 * b * co + b * m * co + part
            + terms)


def double_bwd_workspace_floats(b: int, n: int, h: int, w: int, ci: int,
                                co: int) -> int:
    """f32 scratch of ``cnn4_block_double_bwd`` (mirrors
    ``launch_double_bwd``), each part rounded up to 16 bytes: y and v
    ``[B, M, Co]``; the tile statistics and the statistics (pairs); the
    five BN sums a tile; eight constants a (task, channel); the wgrad
    partials ``[B, chunks, 9 Ci Co + Co]`` where the positions are split
    into more than one chunk."""
    m = n * out_hw(h) * out_hw(w)
    if b == 0 or m == 0:
        return 0
    tiles, chunks = _cdiv(m, _TILE_M), _cdiv(m, dw_chunk(b, m, ci, co))
    part = b * chunks * (9 * ci * co + co) if chunks > 1 else 0
    return (sum(_cdiv(k, 4) * 4 for k in (
        b * m * co, b * m * co, 2 * b * tiles * co, 2 * b * co,
        5 * b * tiles * co, 8 * b * co)) + part)


# ---------------------------------------------------------------------------
# plain PyTorch twins (CPU path; the card-side reference in chip_smoke.py)
# ---------------------------------------------------------------------------

def _taps(x: torch.Tensor):
    """The 9 stride-2 taps of zero-padded x: tap (dy, dx) at output (i, j)
    reads input (2i + dy - 1, 2j + dx - 1)."""
    ho, wo = out_hw(x.shape[2]), out_hw(x.shape[3])
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return [xp[:, :, dy:dy + 2 * ho - 1:2, dx:dx + 2 * wo - 1:2, :]
            for dy in range(3) for dx in range(3)]


def conv_plain(x, w, b, acc=torch.float32) -> torch.Tensor:
    """The block's conv plus bias in f32 (``_conv_s2`` + b), or in ``acc``
    (float64: the reference the bf16 kernels' agreement is held to)."""
    x, w, b = x.to(acc), w.to(acc), b.to(acc)
    wt = w.reshape(w.shape[0], 9, w.shape[3], w.shape[4])
    y = sum(torch.einsum("bnhwc,bco->bnhwo", t, wt[:, k])
            for k, t in enumerate(_taps(x)))
    return y + b[:, None, None, None, :]


def bn_stats_plain(x, w, b, scale, bias, acc=torch.float32):
    """-> (xhat, inv_std, scale, bias) in f32 (or ``acc``), from
    ``_block_fwd``."""
    y = conv_plain(x, w, b, acc)
    scale, bias = scale.to(acc), bias.to(acc)
    mu = y.mean(dim=(1, 2, 3), keepdim=True)
    var = (y - mu).square().mean(dim=(1, 2, 3), keepdim=True)
    inv = torch.rsqrt(var + EPS)
    return ((y - mu) * inv, inv, scale[:, None, None, None, :],
            bias[:, None, None, None, :])


def block_fwd_plain(x, w, b, scale, bias, acc=torch.float32) -> torch.Tensor:
    xh, _, s, be = bn_stats_plain(x, w, b, scale, bias, acc)
    return torch.relu(xh * s + be).to(x.dtype)


def block_bwd_params_plain(x, w, b, scale, bias, g, acc=torch.float32):
    """-> (dy f32, dw, db, dscale, dbias), from ``_block_bwd`` and
    ``_conv_s2_bwd`` (computed in ``acc``; dy then in ``acc`` too)."""
    xh, inv, s, be = bn_stats_plain(x, w, b, scale, bias, acc)
    dz = g.to(acc) * ((xh * s + be) > 0)
    dscale = (dz * xh).sum(dim=(1, 2, 3))
    dbias = dz.sum(dim=(1, 2, 3))
    dxh = dz * s
    dy = inv * (dxh - dxh.mean(dim=(1, 2, 3), keepdim=True)
                - xh * (dxh * xh).mean(dim=(1, 2, 3), keepdim=True))
    dw = torch.stack([torch.einsum("bnhwc,bnhwo->bco", t, dy)
                      for t in _taps(x.to(acc))], dim=1)
    dw = dw.reshape(w.shape)
    db = dy.sum(dim=(1, 2, 3))
    pd = w.dtype
    return dy, dw.to(pd), db.to(pd), dscale.to(pd), dbias.to(pd)


def block_bwd_input_plain(dy, w, h: int, wd: int,
                          acc=torch.float32) -> torch.Tensor:
    """dx of the conv from its output cotangent dy (f32): the transposed
    stride-2 conv, as the tap scatter of ``_conv_s2_bwd``, computed in
    ``acc`` (float64: the reference the bf16 kernel is held to)."""
    B, N, ho, wo, _ = dy.shape
    ci = w.shape[3]
    dy = dy.to(acc)
    dxp = dy.new_zeros(B, N, h + 2, wd + 2, ci)
    wf = w.to(acc)
    for dyy in range(3):
        for dxx in range(3):
            dxp[:, :, dyy:dyy + 2 * ho - 1:2, dxx:dxx + 2 * wo - 1:2, :] += \
                torch.einsum("bnhwo,bco->bnhwc", dy, wf[:, dyy, dxx])
    return dxp[:, :, 1:1 + h, 1:1 + wd, :].to(w.dtype)


def _wgrad_plain(a, d) -> torch.Tensor:
    """dw-type product: w[tap, ci, co] = sum over positions of a's tap
    (zero-padded, stride 2) times d, -> ``[B, 3, 3, Ci, Co]`` in d's
    dtype."""
    dw = torch.stack([torch.einsum("bnhwc,bnhwo->bco", t, d)
                      for t in _taps(a.to(d.dtype))], dim=1)
    return dw.reshape(a.shape[0], 3, 3, a.shape[4], d.shape[4])


def block_double_bwd_plain(x, w, b, scale, bias, g, cots, need_x=True,
                           need_g=True, acc=torch.float32):
    """The VJP of the block's backward ``(x, w, b, scale, bias, g) -> (dx,
    dw, db, dscale, dbias)`` (:func:`block_bwd_params_plain` and
    :func:`block_bwd_input_plain`) at the cotangents ``cots`` = (c_dx,
    c_dw, c_db, c_ds, c_dbias), each a tensor or None, computed in ``acc``.
    -> (x_bar or None, w_bar, b_bar, scale_bar, None, g_bar or None) in
    the inputs' dtypes; bias_bar is None: the bias reaches the backward
    only through the ReLU mask, whose derivative is zero.

    Per (task, channel), with xhat, inv_std and the mask of the forward,
    gz = g * mask, a = scale * gz, and means over the M positions, the
    backward is dy = inv (a - mean(a) - xhat mean(a xhat)), ds = sum gz
    xhat, dbias = sum gz, dw = wgrad(x, dy), db = sum dy, dx = dgrad(dy,
    w). Its VJP:

    1. v = conv(c_dx, w) + conv(x, c_dw) + c_db, dy's cotangent;
    2. through BN, from the sums Sv = sum v, Svx = sum v xhat, Svg = sum
       v gz, Sg = sum gz, Sgx = sum gz xhat: scale_bar = inv (Svg -
       mean(v) Sg - mean(v xhat) Sgx); g_bar = mask (scale inv (v - mean(v)
       - xhat mean(v xhat)) + c_ds xhat + c_dbias); and y_bar, the
       cotangent of the conv output, as h = d(.)/d xhat at fixed inv_std
       and q = d(.)/d inv_std at fixed xhat taken back through BN's
       normalisation: h = gz (c_ds - inv scale mean(v xhat)) - inv
       (scale Sgx / M) v, q = scale Svg - mean(a) Sv - mean(a xhat) Svx,
       y_bar = inv (h - mean(h) - xhat mean(h xhat)) - q inv^2 xhat / M;
    3. x_bar = dgrad(dy, c_dw) + dgrad(y_bar, w), where ``need_x``;
    4. w_bar = wgrad(c_dx, dy) + wgrad(x, y_bar), b_bar = sum y_bar."""
    c_dx, c_dw, c_db, c_ds, c_dbe = cots
    xh, inv, s, be = bn_stats_plain(x, w, b, scale, bias, acc)
    dims, m = (1, 2, 3), xh.shape[1] * xh.shape[2] * xh.shape[3]
    mask = (xh * s + be) > 0
    gz = g.to(acc) * mask
    sg = gz.sum(dim=dims, keepdim=True)
    sgx = (gz * xh).sum(dim=dims, keepdim=True)
    a_mean, ax_mean = s * sg / m, s * sgx / m
    dy = inv * (gz * s - a_mean - xh * ax_mean)
    wa = w.to(acc)
    v = torch.zeros_like(xh)
    if c_dx is not None:
        v = v + conv_plain(c_dx, wa, torch.zeros_like(b, dtype=acc), acc)
    if c_dw is not None:
        v = v + conv_plain(x, c_dw, torch.zeros_like(b, dtype=acc), acc)
    if c_db is not None:
        v = v + c_db.to(acc)[:, None, None, None, :]
    sv = v.sum(dim=dims, keepdim=True)
    svx = (v * xh).sum(dim=dims, keepdim=True)
    svg = (v * gz).sum(dim=dims, keepdim=True)
    v_mean, vx_mean = sv / m, svx / m
    u_ds, u_dbe = (torch.zeros_like(sv) if c is None
                   else c.to(acc)[:, None, None, None, :]
                   for c in (c_ds, c_dbe))
    s_bar = inv * (svg - v_mean * sg - vx_mean * sgx)
    g_bar = mask * (s * inv * (v - v_mean - xh * vx_mean) + u_ds * xh + u_dbe)
    h = gz * (u_ds - inv * s * vx_mean) - inv * ax_mean * v
    q = s * svg - a_mean * sv - ax_mean * svx
    y_bar = (inv * (h - h.mean(dim=dims, keepdim=True)
                    - xh * (h * xh).mean(dim=dims, keepdim=True))
             - q * inv * inv * xh / m)
    x_bar = None
    if need_x:
        h_in, w_in = x.shape[2], x.shape[3]
        x_bar = block_bwd_input_plain(y_bar, wa, h_in, w_in, acc)
        if c_dw is not None:
            x_bar = x_bar + block_bwd_input_plain(dy, c_dw.to(acc), h_in,
                                                  w_in, acc)
        x_bar = x_bar.to(x.dtype)
    w_bar = _wgrad_plain(x, y_bar)
    if c_dx is not None:
        w_bar = w_bar + _wgrad_plain(c_dx, dy)
    pd = w.dtype
    return (x_bar, w_bar.to(pd), y_bar.sum(dim=dims).to(pd),
            s_bar.reshape(s_bar.shape[0], -1).to(pd), None,
            g_bar.to(g.dtype) if need_g else None)


# ---------------------------------------------------------------------------
# the kernels' decompositions in plain PyTorch (tests only)
# ---------------------------------------------------------------------------

def tile_stats_plain(y: torch.Tensor, tile: int = _TILE_M):
    """Per-tile statistics of y ``[B, M, C]`` over row tiles of ``tile``
    rows, as the forward's kernel A takes them: -> (n ``[T]``, mean
    ``[B, T, C]``, M2 ``[B, T, C]``), M2 the centred sum of squares (two
    passes over the tile)."""
    n, means, m2s = [], [], []
    for r in range(0, y.shape[1], tile):
        part = y[:, r:r + tile]
        mu = part.mean(dim=1)
        n.append(part.shape[1])
        means.append(mu)
        m2s.append((part - mu[:, None]).square().sum(dim=1))
    return (torch.tensor(n, dtype=y.dtype), torch.stack(means, 1),
            torch.stack(m2s, 1))


def combine_tile_stats_plain(n, mean, m2):
    """Chan's combine of per-tile statistics in tile order, as
    ``fwd_combine_kernel``: -> (mean ``[B, C]``, biased var ``[B, C]``)."""
    total = float(n.sum())
    mu = torch.zeros_like(mean[:, 0])
    for t in range(mean.shape[1]):
        mu = mu + n[t] * mean[:, t]
    mu = mu / total
    acc = torch.zeros_like(mu)
    for t in range(mean.shape[1]):
        acc = acc + m2[:, t] + n[t] * (mean[:, t] - mu).square()
    return mu, acc / total


def _bn_dz(y, g, mean, inv, scale, bias):
    """xhat and dz = g * [xhat * scale + bias > 0] of y, g ``[B, M, C]``
    (f32) from per-(task, channel) ``[B, C]`` mean, inv_std, scale, bias."""
    xh = (y - mean[:, None]) * inv[:, None]
    return xh, g * ((xh * scale[:, None] + bias[:, None]) > 0)


def bwd_tile_sums_plain(y, g, mean, inv, scale, bias, tile: int = _TILE_M):
    """Per tile of ``tile`` rows of y and g ``[B, M, C]``, the sums of dz *
    xhat and of dz per channel, as ``bwd_tile_sums_kernel`` takes them ->
    (``[B, T, C]``, ``[B, T, C]``)."""
    xh, dz = _bn_dz(y, g, mean, inv, scale, bias)
    sx, sz = [], []
    for r in range(0, y.shape[1], tile):
        sx.append((dz[:, r:r + tile] * xh[:, r:r + tile]).sum(dim=1))
        sz.append(dz[:, r:r + tile].sum(dim=1))
    return torch.stack(sx, 1), torch.stack(sz, 1)


def combine_bwd_sums_plain(sx, sz, scale, m: int):
    """The tile sums in tile order, as ``bwd_combine_kernel`` -> (dscale,
    dbias, m1, m2), each ``[B, C]``: m1 = scale * dbias / M = mean(dxhat),
    m2 = scale * dscale / M = mean(dxhat * xhat)."""
    ds, db = torch.zeros_like(sx[:, 0]), torch.zeros_like(sz[:, 0])
    for t in range(sx.shape[1]):
        ds, db = ds + sx[:, t], db + sz[:, t]
    return ds, db, scale * db / m, scale * ds / m


def bwd_dy_plain(y, g, mean, inv, scale, bias, m1, m2):
    """dy ``[B, M, C]`` as ``bwd_dw_kernel`` forms it while staging:
    inv_std * (dz * scale - m1 - xhat * m2)."""
    xh, dz = _bn_dz(y, g, mean, inv, scale, bias)
    return inv[:, None] * (dz * scale[:, None] - m1[:, None]
                           - xh * m2[:, None])


def dw_split_plain(x, dy, chunk: int):
    """dw and db as ``bwd_dw_kernel`` and ``bwd_dw_reduce_kernel`` take
    them: per chunk of ``chunk`` positions the implicit GEMM dw[(tap, ci),
    co] = sum_m x_tap(m, ci) * dy(m, co) and db = sum_m dy(m, co), the
    chunks summed in order. x ``[B, N, H, W, Ci]``, dy ``[B, M, Co]`` ->
    (dw ``[B, 3, 3, Ci, Co]``, db ``[B, Co]``), f32."""
    B, ci, co = x.shape[0], x.shape[4], dy.shape[-1]
    a = torch.stack(_taps(x.float()), dim=4).reshape(B, -1, 9 * ci)
    d = dy.reshape(B, -1, co)
    dw, db = a.new_zeros(B, 9 * ci, co), a.new_zeros(B, co)
    for r in range(0, d.shape[1], chunk):
        dw = dw + torch.einsum("bmk,bmo->bko", a[:, r:r + chunk],
                               d[:, r:r + chunk])
        db = db + d[:, r:r + chunk].sum(dim=1)
    return dw.reshape(B, 3, 3, ci, co), db


def split3_bf16(d: torch.Tensor):
    """float32 d as three bfloat16 terms (``split3`` in the source): hi =
    bf16(d), mid = bf16(d - hi), lo = bf16(d - hi - mid). Each remainder
    is exact in float32 and the last has at most 8 significant bits, so
    hi + mid + lo == d exactly for 0 and for 2^-110 <= |d| <= the largest
    bfloat16; below 2^-110 the bits under bfloat16's least subnormal,
    2^-133, are lost."""
    d = d.float()
    hi = d.to(torch.bfloat16)
    r1 = d - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def dw_split3_plain(x, dy, chunk: int, step: int = _TILE_K):
    """dw as ``bwd_dw_tc_kernel`` computes it in bfloat16: x (bf16) times
    each of dy's three bf16 terms, every product exact in float32; per
    k-step of ``step`` positions the three terms' products summed from
    zero, then added to the chunk's sum in float32; the chunk partials
    summed in order. -> dw ``[B, 3, 3, Ci, Co]`` f32."""
    B, ci, co = x.shape[0], x.shape[4], dy.shape[-1]
    a = torch.stack(_taps(x.float()), dim=4).reshape(B, -1, 9 * ci)
    terms = [t.float().reshape(B, -1, co) for t in split3_bf16(dy)]
    dw = a.new_zeros(B, 9 * ci, co)
    for r in range(0, a.shape[1], chunk):
        acc = a.new_zeros(B, 9 * ci, co)
        for k in range(r, min(r + chunk, a.shape[1]), step):
            ak = a[:, k:min(k + step, r + chunk)]
            acc = acc + sum(torch.einsum("bmk,bmo->bko", ak,
                                         t[:, k:k + ak.shape[1]])
                            for t in terms)
        dw = dw + acc
    return dw.reshape(B, 3, 3, ci, co)


def dx_split3_plain(dy, w, h: int, wd: int, step: int = _TC_K):
    """dx as ``bwd_input_tc_kernel`` computes it in bfloat16: per parity
    class (:func:`parity_classes`) and stage of ``step`` channels co of one
    tap, each of dy's three bf16 terms times w (bf16), every product exact
    in float32, the three terms' products summed from zero, then added to
    the class's sum in float32, stages in the kernel's order. dy ``[B, N,
    Ho, Wo, Co]`` f32 -> dx ``[B, N, h, wd, Ci]`` f32."""
    B, N, ho, wo, co = dy.shape
    dx = dy.new_zeros(B, N, h, wd, w.shape[3], dtype=torch.float32)
    # row Ho and column Wo are zero
    terms = [F.pad(t.float(), (0, 0, 0, 1, 0, 1)) for t in split3_bf16(dy)]
    wf = w.float()
    for (ph, pw), taps in parity_classes():
        hc, wc = (h - ph + 1) // 2, (wd - pw + 1) // 2
        acc = dx.new_zeros(B, N, hc, wc, w.shape[3])
        for ty, tx, di, dj in taps:
            for c0 in range(0, co, step):
                wt = wf[:, ty, tx, :, c0:c0 + step]
                acc = acc + sum(torch.einsum(
                    "bnhwo,bco->bnhwc",
                    t[:, :, di:di + hc, dj:dj + wc, c0:c0 + step], wt)
                    for t in terms)
        dx[:, :, ph::2, pw::2, :] = acc
    return dx


def cluster_size(m: int, max_size: int = _CLUSTER_MAX) -> int:
    """The CTAs of a task's cluster over ``m`` positions (the plan's
    ``size``): ceil(tiles / ceil(tiles / max_size)), tiles of 64
    positions."""
    ntiles = _cdiv(m, _TILE_M)
    return _cdiv(ntiles, _cdiv(ntiles, max_size))


def _cluster_y_stats(x, w, b, size: int):
    """y ``[B, M, Co]`` (f32) and its (mean, inv_std) as the cluster
    kernels take them: per rank the two-pass (n, mean, M2) of its rows,
    combined in rank order by Chan's formula (:func:`tile_stats_plain` and
    :func:`combine_tile_stats_plain` with a rank's rows as the tile)."""
    y = conv_plain(x, w, b).reshape(x.shape[0], -1, w.shape[4])
    per = cluster_rows(y.shape[1], size)[0][1]
    mu, var = combine_tile_stats_plain(*tile_stats_plain(y, per))
    return y, mu, torch.rsqrt(var + EPS), per


def block_fwd_cluster_plain(x, w, b, scale, bias, size=None):
    """``fwd_cluster_kernel``'s summation order in plain PyTorch (f32): the
    statistics per rank of a cluster of ``size`` CTAs (:func:`cluster_size`
    of the task's positions by default) combined in rank order, then
    relu((y - mean) inv_std scale + bias), stored in x's dtype."""
    size = size or cluster_size(x.shape[1] * out_hw(x.shape[2])
                                * out_hw(x.shape[3]))
    y, mu, inv, _ = _cluster_y_stats(x, w, b, size)
    out = torch.relu((y - mu[:, None]) * inv[:, None] * scale.float()[:, None]
                     + bias.float()[:, None])
    return out.reshape(*x.shape[:2], out_hw(x.shape[2]), out_hw(x.shape[3]),
                       -1).to(x.dtype)


def block_bwd_params_cluster_plain(x, w, b, scale, bias, g, size=None):
    """``bwd_params_cluster_kernel``'s summation order in plain PyTorch
    (f32) -> (dy f32, dw, db, dscale, dbias) as
    :func:`block_bwd_params_plain`: the statistics as
    :func:`block_fwd_cluster_plain`; each rank's sums of dz * xhat and dz,
    in rank order; dy = inv_std (dz scale - m1 - xhat m2); dw and db as
    each rank's partial over its rows (on the CUDA cores, from the f32 dy,
    in either dtype), summed in rank order."""
    size = size or cluster_size(x.shape[1] * out_hw(x.shape[2])
                                * out_hw(x.shape[3]))
    y, mu, inv, per = _cluster_y_stats(x, w, b, size)
    sc, be = scale.float(), bias.float()
    gf = g.float().reshape(y.shape)
    ds, dbias, m1, m2 = combine_bwd_sums_plain(
        *bwd_tile_sums_plain(y, gf, mu, inv, sc, be, per), sc, y.shape[1])
    dy = bwd_dy_plain(y, gf, mu, inv, sc, be, m1, m2)
    dw, db = dw_split_plain(x, dy, per)
    pd = w.dtype
    return (dy.reshape(g.shape), dw.to(pd), db.to(pd), ds.to(pd),
            dbias.to(pd))


# A bfloat16 output of a kernel against its twin's: within one bfloat16
# ulp of it plus float32 noise, |got - want| <= 2^-7 |want| + 1e-5
# max|want|, and equal in all but a share BF16_SHARE of its elements
# (values within float32 noise of a bfloat16 rounding boundary). The twin
# is taken in float64 (``acc``). BF16_SHARE lies between two readings on
# an H100 at every shape of the card tests (PERF.md, PR 17):
# float32-precision sums differ from the float64 twin in up to 2.2e-3 of
# dw's elements (the f32 twin and the CUDA-core kernels, over up to ~10^5
# positions), a dw taken from dy rounded to one bf16 in 0.32-0.47 of them
# (:func:`rounded_dy_share`).
BF16_RTOL, BF16_ATOL, BF16_SHARE = 2.0 ** -7, 1e-5, 1e-2


def bf16_agreement(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """-> (the largest |got - want| over its limit, BF16_RTOL |want| +
    BF16_ATOL max|want| (at most 1 holds), the share of elements with
    got != want)."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    lim = BF16_RTOL * want.abs() + BF16_ATOL * want.abs().max()
    over = torch.where(d == 0, torch.zeros_like(d), d / lim)
    return (float(over.max()) if d.numel() else 0.0,
            float((d > 0).float().mean()) if d.numel() else 0.0)


def bf16_share_holds(share: float, n: int) -> bool:
    """At most BF16_SHARE of ``n`` elements differ, rounded up to a whole
    element (an output of 64 may hold one value at a tie)."""
    return round(share * n) <= math.ceil(BF16_SHARE * n)


def rounded_dy_share(x, w, b, scale, bias, g) -> float:
    """The share of dw's bf16 elements that a dw taken from dy rounded to
    one bf16 gets wrong against the float64 twin's: what a design that
    rounds dy before the product would give."""
    dy, dw = block_bwd_params_plain(x, w, b, scale, bias, g,
                                    acc=torch.float64)[:2]
    a = torch.stack(_taps(x.float()), dim=4).reshape(
        x.shape[0], -1, 9 * x.shape[4])
    d = dy.to(torch.bfloat16).float().reshape(x.shape[0], -1, dy.shape[-1])
    rounded = torch.einsum("bmk,bmo->bko", a, d).reshape(dw.shape)
    return bf16_agreement(rounded.to(dw.dtype), dw)[1]


def rounded_dy_dx_share(dy, w, h: int, wd: int) -> float:
    """The share of dx's bf16 elements that a dx taken from dy rounded to
    one bf16 gets wrong against the float64 twin's: what a design that
    rounds dy before the product would give (the dx counterpart of
    :func:`rounded_dy_share`)."""
    want = block_bwd_input_plain(dy, w, h, wd, acc=torch.float64)
    rounded = block_bwd_input_plain(dy.to(torch.bfloat16).to(torch.float64),
                                    w, h, wd, acc=torch.float64)
    return bf16_agreement(rounded, want)[1]


def block_inputs(gen: torch.Generator, b: int, n: int, h: int, ci: int,
                 co: int, dtype: torch.dtype):
    """Random block inputs on ``gen``'s device: x, w, b, scale, bias and a
    cotangent g, zero where the ReLU input lies within 1e-3 of its kink:
    there the kernel's and the twin's f32 rounding may disagree on the
    mask, which is a tie, not an error."""
    dev, ho = gen.device, out_hw(h)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = rnd(b, n, h, h, ci).to(dtype)
    w = rnd(b, 3, 3, ci, co, scale=(2.0 / (9 * ci)) ** 0.5).to(dtype)
    bb = rnd(b, co, scale=0.1).to(dtype)
    sc = (torch.rand(b, co, generator=gen, device=dev) * 0.9 + 0.1).to(dtype)
    be = rnd(b, co, scale=0.1).to(dtype)
    xh, _, s_, be_ = bn_stats_plain(x, w, bb, sc, be)
    g = (rnd(b, n, ho, ho, co) * ((xh * s_ + be_).abs() > 1e-3)).to(dtype)
    return x, w, bb, sc, be, g


def parity_classes():
    """The parity classes (hi % 2, wi % 2) of the input positions in the
    order of ``bwd_input_kernel``'s and ``bwd_input_tc_kernel``'s grid,
    each with its taps (ty, tx, di, dj): input (2a + ph, 2b + pw) takes
    w[ty, tx] times dy at output (a + di, b + dj)."""
    rows = {0: [(1, 0)], 1: [(0, 1), (2, 0)]}
    return [((ph, pw), [(ty, tx, di, dj) for ty, di in rows[ph]
                        for tx, dj in rows[pw]])
            for ph, pw in ((1, 1), (1, 0), (0, 1), (0, 0))]


def block_bwd_input_parity_plain(dy, w, h: int, wd: int) -> torch.Tensor:
    """dx as ``bwd_input_kernel`` computes it: per parity class, the sum
    over its taps of dy at the tap's source rows (zero past the last
    output row or column) times w[tap] read as ``[Ci, Co]``."""
    B, N, ho, wo, _ = dy.shape
    dx = dy.new_zeros(B, N, h, wd, w.shape[3])
    dyp = F.pad(dy, (0, 0, 0, 1, 0, 1))    # row Ho and column Wo are zero
    wf = w.float()
    for (ph, pw), taps in parity_classes():
        hc, wc = (h - ph + 1) // 2, (wd - pw + 1) // 2
        for ty, tx, di, dj in taps:
            src = dyp[:, :, di:di + hc, dj:dj + wc, :]
            dx[:, :, ph::2, pw::2, :] += torch.einsum(
                "bnhwo,bco->bnhwc", src, wf[:, ty, tx])
    return dx.to(w.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _load():
    global _lib
    if _lib is None:
        from exploring_meta_tpu_torch.cuda import build
        lib = build.load(_SOURCE)
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.cnn4_block_fwd.argtypes = [I] + [P] * 7 + [I] * 6 + [P]
        lib.cnn4_block_bwd_params.argtypes = [I] + [P] * 12 + [I] * 6 + [P]
        lib.cnn4_block_bwd_input.argtypes = [I] + [P] * 3 + [I] * 6 + [P]
        lib.cnn4_block_double_bwd.argtypes = [I] + [P] * 18 + [I] * 6 + [P]
        lib.cnn4_cluster_plan.argtypes = [I] * 8 + [P]
        lib.cnn4_cluster_max.argtypes = [P]
        for fn in (lib.cnn4_block_fwd, lib.cnn4_block_bwd_params,
                   lib.cnn4_block_bwd_input, lib.cnn4_block_double_bwd,
                   lib.cnn4_cluster_plan, lib.cnn4_cluster_max):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise RuntimeError(f"fused CNN4 block: unsupported device {t.device}")
    return False


def _check(x, w, b, scale, bias):
    """Raise on anything the kernels do not take; -> (B, N, H, W, Ci, Co)."""
    if x.ndim != 5 or w.ndim != 5 or w.shape[1:3] != (3, 3):
        raise ValueError(f"fused CNN4 block wants x [B,N,H,W,Ci] and w "
                         f"[B,3,3,Ci,Co], got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    B, N, H, W, ci = x.shape
    co = w.shape[4]
    if w.shape[:1] + w.shape[3:4] != (B, ci):
        raise ValueError(f"w {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)}")
    for t in (b, scale, bias):
        if tuple(t.shape) != (B, co):
            raise ValueError(f"per-channel param {tuple(t.shape)} != "
                             f"{(B, co)}")
    for t in (x, w, b, scale, bias):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError("fused CNN4 block wants every tensor in x's "
                             "dtype and on x's device")
        if not t.is_contiguous():
            raise ValueError("fused CNN4 block wants contiguous tensors")
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused CNN4 block: unsupported dtype {x.dtype}")
    if B > MAX_TASKS:
        raise ValueError(f"fused CNN4 block: {B} tasks in one launch, above "
                         f"the grid's {MAX_TASKS}")
    return B, N, H, W, ci, co


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def source_cluster_plan(dtype: torch.dtype, kernel: str, b: int, n: int,
                        h: int, w: int, ci: int, co: int):
    """The route the built source takes at a shape on the current device
    (its exported ``cnn4_cluster_plan``, the function its launches call):
    a :class:`ClusterPlan` or None for the tiled kernels. Needs the CUDA
    toolkit (it builds) and a card."""
    out = (ctypes.c_int * 2)()
    _raise_on(_load().cnn4_cluster_plan(
        _DTYPES[dtype], int(kernel == "cnn4_block_bwd_params"), b, n, h, w,
        ci, co, ctypes.addressof(out)), "cnn4_cluster_plan")
    return ClusterPlan(*out) if out[0] else None


def source_cluster_max() -> int:
    """The most CTAs a cluster the current device schedules (the source's
    ``cnn4_cluster_max``): 16, or the portable 8."""
    out = (ctypes.c_int * 1)()
    _raise_on(_load().cnn4_cluster_max(ctypes.addressof(out)),
              "cnn4_cluster_max")
    return out[0]


_plans: dict = {}


def _plan(x: torch.Tensor, kernel: str, shape: tuple):
    """source_cluster_plan of a call on x's card, asked once a shape."""
    key = (x.device.index, x.dtype, kernel, shape)
    if key not in _plans:
        _plans[key] = source_cluster_plan(x.dtype, kernel, *shape)
    return _plans[key]


# Calls by route: for the forward and bwd_params a cluster kernel or the
# tiled kernels (calls that launched); for the double backward its kernels
# (on a card) or its plain twin (on the CPU)
ROUTES = {"cnn4_block_fwd": ("fwd_cluster_kernel", "fwd_tiled"),
          "cnn4_block_bwd_params": ("bwd_params_cluster_kernel",
                                    "bwd_params_tiled"),
          "cnn4_block_double_backward": ("double_bwd_kernels",
                                         "double_bwd_plain")}
_routes = {"launches": {}, "captured": {}}


def _count_route(route: str, on_card: bool = True) -> None:
    key = ("captured" if on_card and torch.cuda.is_current_stream_capturing()
           else "launches")
    _routes[key][route] = _routes[key].get(route, 0) + 1


def routes() -> dict:
    """Calls by route: of the forward and of ``bwd_params`` that launched
    (``fwd_cluster_kernel``, ``fwd_tiled``, ``bwd_params_cluster_kernel``,
    ``bwd_params_tiled``), and of the double backward (``double_bwd_kernels``,
    ``double_bwd_plain``)."""
    return {r: _routes["launches"].get(r, 0)
            for pair in ROUTES.values() for r in pair}


def captured_routes() -> dict:
    """Calls recorded into CUDA graphs, by route."""
    return {r: _routes["captured"].get(r, 0)
            for pair in ROUTES.values() for r in pair}


def _workspace(floats: int, plan, device) -> torch.Tensor:
    """The tiled route's f32 scratch; a cluster launch takes none."""
    return torch.empty(0 if plan else floats, dtype=torch.float32,
                       device=device)


def block_fwd(x, w, b, scale, bias) -> torch.Tensor:
    """Block forward -> a ``[B, N, Ho, Wo, Co]`` in x's dtype."""
    with span("cnn4_block_fwd", ranged=True):
        if _on_cpu(x):
            return block_fwd_plain(x, w, b, scale, bias)
        return _launch_fwd(x, w, b, scale, bias)


def _launch_fwd(x, w, b, scale, bias) -> torch.Tensor:
    B, N, H, W, ci, co = _check(x, w, b, scale, bias)
    out = torch.empty(B, N, out_hw(H), out_hw(W), co, dtype=x.dtype,
                      device=x.device)
    with torch.cuda.device(x.device):
        plan = _plan(x, "cnn4_block_fwd", (B, N, H, W, ci, co))
        ws = _workspace(fwd_workspace_floats(B, N, H, W, co, x.dtype), plan,
                        x.device)
        err = _load().cnn4_block_fwd(
            _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), b.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), out.data_ptr(), ws.data_ptr(),
            B, N, H, W, ci, co, _stream(x))
    _raise_on(err, "cnn4_block_fwd")
    count_launch(block_fwd)
    _count_route(ROUTES["cnn4_block_fwd"][plan is None])
    return out


def block_bwd_params(x, w, b, scale, bias, g):
    """-> (dy f32 ``[B, N, Ho, Wo, Co]``, dw, db, dscale, dbias)."""
    with span("cnn4_block_bwd_params", ranged=True):
        if _on_cpu(x):
            return block_bwd_params_plain(x, w, b, scale, bias, g)
        return _launch_bwd_params(x, w, b, scale, bias, g)


def _launch_bwd_params(x, w, b, scale, bias, g):
    B, N, H, W, ci, co = _check(x, w, b, scale, bias)
    shape = (B, N, out_hw(H), out_hw(W), co)
    if tuple(g.shape) != shape or g.dtype != x.dtype \
            or g.device != x.device or not g.is_contiguous():
        raise ValueError(f"cotangent {tuple(g.shape)} {g.dtype} does not "
                         f"match the block output {shape} {x.dtype}")
    dy = torch.empty(shape, dtype=torch.float32, device=x.device)
    dw, db, ds, dbe = (torch.empty_like(t) for t in (w, b, scale, bias))
    with torch.cuda.device(x.device):
        plan = _plan(x, "cnn4_block_bwd_params", (B, N, H, W, ci, co))
        ws = _workspace(bwd_params_workspace_floats(B, N, H, W, ci, co,
                                                    x.dtype), plan, x.device)
        err = _load().cnn4_block_bwd_params(
            _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), b.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), g.data_ptr(), dy.data_ptr(),
            dw.data_ptr(), db.data_ptr(), ds.data_ptr(), dbe.data_ptr(),
            ws.data_ptr(), B, N, H, W, ci, co, _stream(x))
    _raise_on(err, "cnn4_block_bwd_params")
    count_launch(block_bwd_params)
    _count_route(ROUTES["cnn4_block_bwd_params"][plan is None])
    return dy, dw, db, ds, dbe


def block_bwd_input(dy, w, h: int, wd: int) -> torch.Tensor:
    """dx ``[B, N, h, wd, Ci]`` in w's dtype from dy (f32, from
    :func:`block_bwd_params`)."""
    with span("cnn4_block_bwd_input", ranged=True):
        if _on_cpu(dy):
            return block_bwd_input_plain(dy, w, h, wd)
        return _launch_bwd_input(dy, w, h, wd)


def _launch_bwd_input(dy, w, h: int, wd: int) -> torch.Tensor:
    B, N, ho, wo, co = dy.shape
    ci = w.shape[3]
    if (dy.dtype != torch.float32 or w.dtype not in _DTYPES
            or tuple(w.shape) != (B, 3, 3, ci, co)
            or (ho, wo) != (out_hw(h), out_hw(wd))
            or w.device != dy.device
            or not (dy.is_contiguous() and w.is_contiguous())):
        raise ValueError(f"block_bwd_input: dy {tuple(dy.shape)} "
                         f"{dy.dtype}, w {tuple(w.shape)} {w.dtype} and "
                         f"input {h}x{wd} do not fit")
    dx = torch.empty(B, N, h, wd, ci, dtype=w.dtype, device=dy.device)
    with torch.cuda.device(dy.device):
        err = _load().cnn4_block_bwd_input(
            _DTYPES[w.dtype], dy.data_ptr(), w.data_ptr(), dx.data_ptr(),
            B, N, h, wd, ci, co, _stream(dy))
    _raise_on(err, "cnn4_block_bwd_input")
    count_launch(block_bwd_input)
    return dx


def block_double_bwd(x, w, b, scale, bias, g, dy, cots, need_x=True,
                     need_g=True):
    """The VJP of the block's backward at ``cots`` = (c_dx, c_dw, c_db,
    c_ds, c_dbias), each a tensor or None: -> (x_bar or None, w_bar, b_bar,
    scale_bar, None, g_bar or None), as :func:`block_double_bwd_plain`.
    ``dy`` is the backward's f32 dy (:func:`block_bwd_params`), which the
    kernels read; the twin forms its own. Marks the device, so its time
    shows inside a replayed, traced iteration."""
    with span("cnn4_block_double_backward", device=x.device, ranged=True):
        if _on_cpu(x):
            _count_route(ROUTES["cnn4_block_double_backward"][1],
                         on_card=False)
            return block_double_bwd_plain(x, w, b, scale, bias, g, cots,
                                          need_x, need_g)
        return _launch_double_bwd(x, w, b, scale, bias, g, dy, cots, need_x,
                                  need_g)


def _launch_double_bwd(x, w, b, scale, bias, g, dy, cots, need_x, need_g):
    B, N, H, W, ci, co = _check(x, w, b, scale, bias)
    shape = (B, N, out_hw(H), out_hw(W), co)
    cots = [None if c is None else c.contiguous() for c in cots]
    wants = [(g, shape, x.dtype), (dy, shape, torch.float32)] + [
        (c, tuple(t.shape), x.dtype)
        for c, t in zip(cots, (x, w, b, scale, bias)) if c is not None]
    for t, want, dt in wants:
        if (tuple(t.shape) != want or t.dtype != dt or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"block_double_bwd: {tuple(t.shape)} {t.dtype} "
                             f"does not match {want} {dt}")
    xbar = torch.empty_like(x) if need_x else None
    wbar, bbar, sbar = (torch.empty_like(t) for t in (w, b, scale))
    gbar = torch.empty_like(g) if need_g else None
    ws = torch.empty(double_bwd_workspace_floats(B, N, H, W, ci, co),
                     dtype=torch.float32, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        err = _load().cnn4_block_double_bwd(
            _DTYPES[x.dtype], *(ptr(t) for t in (
                x, w, b, scale, bias, g, dy, *cots, xbar, wbar, bbar, sbar,
                gbar, ws)), B, N, H, W, ci, co, _stream(x))
    _raise_on(err, "cnn4_block_double_bwd")
    count_launch(block_double_bwd)
    _count_route(ROUTES["cnn4_block_double_backward"][0])
    return xbar, wbar, bbar, sbar, None, gbar


block_fwd.launches = block_fwd.captured = 0
block_bwd_params.launches = block_bwd_params.captured = 0
block_bwd_input.launches = block_bwd_input.captured = 0
block_double_bwd.launches = block_double_bwd.captured = 0

KERNELS = {"cnn4_block_fwd": block_fwd,
           "cnn4_block_bwd_params": block_bwd_params,
           "cnn4_block_bwd_input": block_bwd_input,
           "cnn4_block_double_backward": block_double_bwd}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def captured_counts() -> dict:
    """Calls recorded into CUDA graphs (each replay launches them again)."""
    return {name: fn.captured for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = fn.captured = 0
    for counts in _routes.values():
        counts.clear()


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

def _kernel_grads(need_dx: bool, x, w, b, scale, bias, g):
    """The block's backward on the two bwd kernels -> (dy, dx or None, dw,
    db, dscale, dbias); dx only where ``need_dx``."""
    dy, dw, db, ds, dbe = block_bwd_params(x, w, b, scale, bias, g)
    dx = block_bwd_input(dy, w, x.shape[2], x.shape[3]) if need_dx else None
    return dy, dx, dw, db, ds, dbe


def _reference_block(x, w, b, scale, bias) -> torch.Tensor:
    """The block in the port's per-op layers (grouped conv stride 2, pad 1
    -> batch-stat BN -> ReLU, per task), as ``_pure_base`` is in JAX: the
    oracle the tests differentiate twice to hold the double backward."""
    from exploring_meta_tpu_torch.models.layers import (
        _conv_nhwc, batch_norm, relu,
    )
    y = _conv_nhwc(x, w, 2, 1) + b[:, None, None, None, :]
    return relu(batch_norm({"scale": scale, "bias": bias}, y, eps=EPS))


class FusedBlock(torch.autograd.Function):
    """One fused block: forward on ``cnn4_block_fwd``, backward on
    ``cnn4_block_bwd_params`` and ``cnn4_block_bwd_input``.

    Under ``create_graph=True`` (second-order MAML) the backward is
    :class:`FusedBlockBackward`, whose own forward is the same kernel
    backward and whose backward is its VJP on ``cnn4_block_double_bwd``;
    otherwise the backward is first order."""

    @staticmethod
    def forward(ctx, x, w, b, scale, bias):
        ctx.save_for_backward(x, w, b, scale, bias)
        return block_fwd(x, w, b, scale, bias)

    @staticmethod
    def backward(ctx, g):
        if torch.is_grad_enabled():
            return FusedBlockBackward.apply(ctx.needs_input_grad[0],
                                            *ctx.saved_tensors, g)
        return FusedBlock._backward(ctx, g)

    @staticmethod
    @once_differentiable
    def _backward(ctx, g):
        return _kernel_grads(ctx.needs_input_grad[0], *ctx.saved_tensors,
                             g.contiguous())[1:]


class FusedBlockBackward(torch.autograd.Function):
    """The fused block's backward as a differentiable op (the port of
    ``_bwd_op`` and its tangent ``_bwd_op_jvp``, ``cnn4_pallas.py:538-548``).

    Forward: the primal backward on the kernels, ``(x, w, b, scale, bias,
    g) -> (dx, dw, db, dscale, dbias)`` (dx is None unless ``need_dx``).
    Backward: the VJP of that map, analytic, on the kernels of
    ``cnn4_block_double_bwd`` (:func:`block_double_bwd`; its twin on the
    CPU); a cotangent no one sent is None and adds no terms. It is once
    differentiable.

    JAX also needs a forward tangent (``_fwd_op_jvp``) because its outer
    ``grad`` linearises the whole staged graph, the kernel forward
    included. Reverse over reverse in PyTorch does not: the outer pass
    differentiates the forward through :meth:`FusedBlock.backward` itself,
    which runs on the kernels, so no counterpart is written."""

    @staticmethod
    def forward(ctx, need_dx, x, w, b, scale, bias, g):
        g = g.contiguous()
        dy, *grads = _kernel_grads(need_dx, x, w, b, scale, bias, g)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, w, b, scale, bias, g, dy)
        return tuple(grads)

    @staticmethod
    @once_differentiable
    def backward(ctx, *cotangents):
        need = ctx.needs_input_grad[1:]
        grads = block_double_bwd(*ctx.saved_tensors, cotangents, need[0],
                                 need[5])
        return (None, *(t if n else None for t, n in zip(grads, need)))


def _per_task(p: torch.Tensor, B: int, shared_ndim: int) -> torch.Tensor:
    if p.ndim == shared_ndim:
        p = p.unsqueeze(0).expand((B,) + tuple(p.shape))
    return p.contiguous()


def fused_omni_base(blocks: list, x: torch.Tensor) -> torch.Tensor:
    """Pooled CNN4-Omniglot base features: 4 fused blocks, then the
    spatial mean (``cnn4_pallas.py:fused_omni_base``).

    ``x`` is ``[B, N, H, W, C]`` (or ``[N, H, W, C]``, one task); block
    params are shared or per task (leading ``[B]``). -> ``[B, N, hidden]``
    (or ``[N, hidden]``)."""
    single = x.ndim == 4
    a = (x.unsqueeze(0) if single else x).contiguous()
    B = a.shape[0]
    for blk in blocks:
        a = FusedBlock.apply(
            a, _per_task(blk["conv"]["w"], B, 4),
            *(_per_task(p, B, 1) for p in (blk["conv"]["b"],
                                           blk["bn"]["scale"],
                                           blk["bn"]["bias"])))
    feats = a.mean(dim=(-3, -2))
    return feats[0] if single else feats
