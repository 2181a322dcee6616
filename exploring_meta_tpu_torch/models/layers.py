"""Functional NN layers in the JAX package's layout (port of
``exploring_meta_tpu/models/layers.py``).

Activations are NHWC, conv weights HWIO, linear weights ``[in, out]``.
Where JAX ``vmap``-ed over tasks, the port writes the task axis out:

- an activation is ``[N, H, W, C]`` (one task) or ``[B, N, H, W, C]``;
- a param may carry a leading ``[B]`` (per-task, e.g. adapted params) or
  not (shared by every task).

``batch_norm`` takes batch statistics over (N, H, W) per channel and per
task, never across tasks: that is what ``vmap`` of the JAX layer gives.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# "highest": full f32 convs and matmuls (TF32 off) and bf16 GEMMs reduced
# in f32, as XLA accumulates its bf16 dots: the JAX package's default for
# accuracy parity; "high"/"default" allow TF32 and cuBLAS's reduced-
# precision bf16 reductions.
_PRECISION = "highest"

# Stride-2 3x3 conv lowering: "direct" (F.conv2d), "s2d" (the exact
# space-to-depth form) or "fused" (the CNN4-Omniglot base on the fused
# conv-BN-ReLU kernels, cuda/cnn4_cuda.py; other specs take "direct").
_CONV_IMPL = "fused"


def _apply_precision(mode: str) -> None:
    relaxed = mode != "highest"
    torch.backends.cuda.matmul.allow_tf32 = relaxed
    torch.backends.cudnn.allow_tf32 = relaxed
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
        relaxed)


def set_precision(mode: str) -> None:
    """"highest" (f32 parity: TF32 off for matmuls and cuDNN convs, bf16
    GEMMs reduced in f32) or "high"/"default" (TF32 and reduced-precision
    bf16 reductions allowed)."""
    global _PRECISION
    if mode not in ("highest", "default", "high"):
        raise ValueError(f"unknown precision {mode!r}")
    _PRECISION = mode
    _apply_precision(mode)


def get_precision() -> str:
    return _PRECISION


def set_conv_impl(mode: str) -> None:
    """Select the conv lowering: "direct" | "s2d" | "fused"."""
    global _CONV_IMPL
    if mode not in ("direct", "s2d", "fused"):
        raise ValueError(f"unknown conv impl {mode!r}")
    _CONV_IMPL = mode


def get_conv_impl() -> str:
    return _CONV_IMPL


def task_param(p: torch.Tensor, per_task_ndim: int, tail: int) -> torch.Tensor:
    """View a param for broadcasting against a task-batched activation.

    ``per_task_ndim`` is the param's rank without a task axis; a param of
    higher rank is per-task and gets ``tail`` singleton axes inserted after
    its task axis (e.g. a ``[B, C]`` BN scale against ``[B, N, H, W, C]``
    becomes ``[B, 1, 1, 1, C]``)."""
    if p.ndim == per_task_ndim:
        return p
    return p.reshape(p.shape[:1] + (1,) * tail + p.shape[1:])


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b``; ``x [..., N, in]``, ``w [in, out]`` or ``[B, in, out]``."""
    return torch.matmul(x, p["w"]) + task_param(p["b"], 1, 1)


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int,
               padding) -> torch.Tensor:
    """NHWC x HWIO conv, no bias, on one task or a task batch.

    Shared weights fold the task axis into N; per-task weights ``[B, ...]``
    run as one grouped conv with a group per task."""
    if x.ndim == 4:
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     stride=stride, padding=padding)
        return y.permute(0, 2, 3, 1)
    B, N, H, W, C = x.shape
    if w.ndim == 4:
        y = _conv_nhwc(x.reshape(B * N, H, W, C), w, stride, padding)
        return y.reshape((B, N) + y.shape[1:])
    k, co = w.shape[1], w.shape[-1]
    xg = x.permute(1, 0, 4, 2, 3).reshape(N, B * C, H, W)
    wg = w.permute(0, 4, 3, 1, 2).reshape(B * co, C, k, w.shape[2])
    y = F.conv2d(xg, wg, stride=stride, padding=padding, groups=B)
    return y.reshape(N, B, co, y.shape[2], y.shape[3]).permute(1, 0, 3, 4, 2)


def conv2d(p: dict, x: torch.Tensor, stride: int = 1,
           padding: int = 1) -> torch.Tensor:
    """NHWC conv with an HWIO kernel (optionally per task) plus bias."""
    if stride == 2 and p["w"].shape[-4] == 3 and _CONV_IMPL == "s2d":
        return _conv2d_s2d(p, x, padding)
    y = _conv_nhwc(x, p["w"], stride, padding)
    return y + task_param(p["b"], 1, 3)


def _s2d_kernel(w: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3, Ci, Co] -> the [..., 2, 2, 4*Ci, Co] kernel of the
    space-to-depth conv (tap (dy, dx) lands at s2d tap (dy//2, dx//2),
    parity slot (dy%2, dx%2); 7 of the 16 slots stay zero)."""
    lead = w.shape[:-4]
    ci, co = w.shape[-2], w.shape[-1]
    w2 = w.new_zeros(lead + (2, 2, 2, 2, ci, co))
    for dy in range(3):
        for dx in range(3):
            w2[..., dy // 2, dx // 2, dy % 2, dx % 2, :, :] = w[..., dy, dx, :, :]
    return w2.reshape(lead + (2, 2, 4 * ci, co))


def _conv2d_s2d(p: dict, x: torch.Tensor, padding: int) -> torch.Tensor:
    """Stride-2 3x3 conv as pad -> space-to-depth(2) -> 2x2 VALID conv
    (exact; odd padded extents get one extra zero row/col that only feeds
    zero tap slots)."""
    h, wd, c = x.shape[-3:]
    ph, pw = h + 2 * padding, wd + 2 * padding
    xp = F.pad(x, (0, 0, padding, padding + pw % 2, padding, padding + ph % 2))
    ph += ph % 2
    pw += pw % 2
    lead = x.shape[:-3]
    xs = xp.reshape(lead + (ph // 2, 2, pw // 2, 2, c))
    nd = len(lead)
    xs = xs.permute(*range(nd), nd, nd + 2, nd + 1, nd + 3, nd + 4)
    xs = xs.reshape(lead + (ph // 2, pw // 2, 4 * c))
    y = _conv_nhwc(xs, _s2d_kernel(p["w"]), 1, 0)
    return y + task_param(p["b"], 1, 3)


def batch_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Batch-statistics BN over (N, H, W) per channel, biased variance
    (torch training-mode semantics), per task for ``[B, N, H, W, C]``."""
    dims = (-4, -3, -2)
    mean = x.mean(dim=dims, keepdim=True)
    var = (x - mean).square().mean(dim=dims, keepdim=True)
    xn = (x - mean) * torch.rsqrt(var + eps)
    return (xn * task_param(p["scale"], 1, 3)
            + task_param(p["bias"], 1, 3))


def max_pool2d(x: torch.Tensor, window: int = 2,
               stride: int | None = None) -> torch.Tensor:
    """MaxPool with VALID padding (ceil_mode=False), NHWC."""
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    y = F.max_pool2d(x.reshape((-1, h, w, c)).permute(0, 3, 1, 2),
                     window, stride or window)
    return y.permute(0, 2, 3, 1).reshape(lead + y.shape[2:] + (c,))


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def mlp_apply(layers: list, x: torch.Tensor, activation) -> torch.Tensor:
    """Linear layers with ``activation`` between all but the last."""
    for p in layers[:-1]:
        x = activation(linear(p, x))
    return linear(layers[-1], x)


_apply_precision(_PRECISION)
