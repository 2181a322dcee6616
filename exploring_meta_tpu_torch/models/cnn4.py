"""CNN4 backbones for few-shot vision (port of
``exploring_meta_tpu/models/cnn4.py``).

- Omniglot: 4x [conv3x3 stride-2 -> BN -> ReLU], 64 channels, input
  [N, 28, 28, 1], global spatial mean -> Linear(64 -> ways), N(0,1) head.
- Mini-ImageNet: 4x [conv3x3 stride-1 -> BN -> ReLU -> maxpool2], 32
  channels, input [N, 84, 84, 3], flatten 5*5*32 -> xavier Linear.
- The two ANIL specs.

Params are the JAX package's nested dict/list, in its layout:
``{"base": [{"conv": {"w" HWIO, "b"}, "bn": {"scale", "bias"}}] * layers,
"head": {"w" [in, out], "b"}}``. Images are NHWC, ``[N, H, W, C]`` for one
task or ``[B, N, H, W, C]`` for B tasks; params may be shared or per task.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from exploring_meta_tpu_torch.device import resolve_device
from exploring_meta_tpu_torch.models import init as pinit
from exploring_meta_tpu_torch.models.layers import (
    batch_norm, conv2d, get_conv_impl, linear, max_pool2d, relu,
)
from exploring_meta_tpu_torch.utils.tree import (
    tree_from_items, tree_items, tree_leaves,
)


class CNN4Spec(NamedTuple):
    """Static architecture description."""
    channels: int
    hidden: int
    layers: int
    max_pool: bool         # True: stride-1 conv + maxpool; False: stride-2
    head_in: int
    ways: int
    image_size: int
    head_init: str         # "normal" | "xavier" | "torch_default"
    global_pool: bool      # True: spatial mean into the head (omniglot)


def omniglot_spec(ways: int = 5, hidden: int = 64, layers: int = 4) -> CNN4Spec:
    return CNN4Spec(channels=1, hidden=hidden, layers=layers, max_pool=False,
                    head_in=hidden, ways=ways, image_size=28,
                    head_init="normal", global_pool=True)


def mini_imagenet_spec(ways: int = 5, hidden: int = 32,
                       layers: int = 4) -> CNN4Spec:
    return CNN4Spec(channels=3, hidden=hidden, layers=layers, max_pool=True,
                    head_in=25 * hidden, ways=ways, image_size=84,
                    head_init="xavier", global_pool=False)


def anil_omniglot_spec(ways: int = 5) -> CNN4Spec:
    """ANIL-vision Omniglot: hidden 32, stride-2, flattened 2*2*32 = 128."""
    return CNN4Spec(channels=1, hidden=32, layers=4, max_pool=False,
                    head_in=128, ways=ways, image_size=28,
                    head_init="torch_default", global_pool=False)


def anil_mini_imagenet_spec(ways: int = 5) -> CNN4Spec:
    """ANIL-vision Mini-ImageNet: hidden 64, maxpool, flattened 1600."""
    return CNN4Spec(channels=3, hidden=64, layers=4, max_pool=True,
                    head_in=1600, ways=ways, image_size=84,
                    head_init="torch_default", global_pool=False)


def init_conv_base(gen: torch.Generator, spec: CNN4Spec, device=None) -> list:
    blocks = []
    in_ch = spec.channels
    for _ in range(spec.layers):
        blocks.append({
            "conv": pinit.conv_params(gen, 3, in_ch, spec.hidden,
                                      device=device),
            "bn": pinit.batchnorm_params(gen, spec.hidden, device=device),
        })
        in_ch = spec.hidden
    return blocks


def init_cnn4(gen: torch.Generator, spec: CNN4Spec, device=None) -> dict:
    """Fresh params drawn from ``gen``, placed on ``device`` (the card
    unless ``device="cpu"``)."""
    dev = resolve_device(device)
    return {"base": init_conv_base(gen, spec, device=dev),
            "head": pinit.linear_params(gen, spec.head_in, spec.ways,
                                        init=spec.head_init, device=dev)}


def conv_block_apply(p: dict, x: torch.Tensor, max_pool: bool) -> torch.Tensor:
    """conv -> BN -> ReLU -> (maxpool | identity); stride 2 when not
    max-pooling."""
    x = conv2d(p["conv"], x, stride=1 if max_pool else 2, padding=1)
    x = relu(batch_norm(p["bn"], x))
    if max_pool:
        x = max_pool2d(x, 2, 2)
    return x


def base_apply(base: list, x: torch.Tensor, max_pool: bool,
               n_blocks: int | None = None,
               remat: bool = False) -> torch.Tensor:
    """The first ``n_blocks`` conv blocks (all by default), per-op path.

    ``remat=True`` checkpoints each block (``torch.utils.checkpoint``): the
    backward recomputes a block's internals from its input instead of
    keeping them, trading FLOPs for memory."""
    for p in (base if n_blocks is None else base[:n_blocks]):
        x = (checkpoint(conv_block_apply, p, x, max_pool, use_reentrant=False)
             if remat else conv_block_apply(p, x, max_pool))
    return x


def uses_fused_base(spec: CNN4Spec) -> bool:
    """The routing rule of ``cnn4.py:140-141``: the Omniglot-shaped base
    (stride-2 blocks, global mean, 4 layers) runs on the fused kernels
    under ``set_conv_impl("fused")``; every other spec runs per op."""
    return (get_conv_impl() == "fused" and spec.global_pool
            and not spec.max_pool and spec.layers == 4)


def cnn4_features(params: dict, spec: CNN4Spec, x: torch.Tensor,
                  remat: bool = False) -> torch.Tensor:
    """Base output flattened to the head input: ``[..., N, head_in]``.
    ``remat`` checkpoints the per-op blocks (:func:`base_apply`); the fused
    base keeps nothing inside a block and ignores it, as in JAX."""
    if uses_fused_base(spec):
        from exploring_meta_tpu_torch.cuda.cnn4_cuda import fused_omni_base
        return fused_omni_base(params["base"], x)
    x = base_apply(params["base"], x, spec.max_pool, remat=remat)
    if spec.global_pool:
        return x.mean(dim=(-3, -2))
    return x.reshape(x.shape[:-3] + (-1,))


def cnn4_apply(params: dict, spec: CNN4Spec, x: torch.Tensor) -> torch.Tensor:
    """Full forward: images -> ``[..., N, ways]`` logits."""
    return linear(params["head"], cnn4_features(params, spec, x))


def cnn4_head_apply(params: dict, feats: torch.Tensor) -> torch.Tensor:
    """Head only, on pre-extracted features (the ANIL inner loop)."""
    return linear(params["head"], feats)


def get_rep_layer(params: dict, spec: CNN4Spec, x: torch.Tensor,
                  layer: int) -> torch.Tensor:
    """Activations after ``layer`` conv blocks; ``layer == -1`` gives
    logits: images (``[N, H, W, C]`` or ``[B, N, H, W, C]``) run the full
    forward, features (``[N, d]`` or ``[B, N, d]``) only the head."""
    if layer == -1:
        if x.ndim >= 4:
            return cnn4_apply(params, spec, x)
        return linear(params["head"], x)
    return base_apply(params["base"], x, spec.max_pool, n_blocks=layer)


def count_params(params) -> int:
    return sum(p.numel() for p in tree_leaves(params))


class CNN4(nn.Module):
    """Holds CNN4 params as ``nn.Parameter``s; ``forward`` is
    :func:`cnn4_apply`. :meth:`params` returns them as the nested tree."""

    def __init__(self, spec: CNN4Spec, params: dict):
        super().__init__()
        self.spec = spec
        self.flat = nn.ParameterDict({
            path.replace("/", "__"): nn.Parameter(leaf)
            for path, leaf in tree_items(params)})

    def params(self) -> dict:
        return tree_from_items((k.replace("__", "/"), v)
                               for k, v in self.flat.items())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return cnn4_apply(self.params(), self.spec, x)
