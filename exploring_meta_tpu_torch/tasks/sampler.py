"""Episodic N-way/K-shot task sampler on the device (port of
``exploring_meta_tpu/tasks/sampler.py``).

A task is ``ways`` classes drawn without replacement, ``2*shots`` samples
per class drawn without replacement, labels 0..ways-1 in class-major
order, and an optional per-class rotation by a random multiple of 90
degrees. Draws without replacement are the argsort of uniforms, as in
the JAX sampler. Every draw comes from the given ``torch.Generator``.
"""

from __future__ import annotations

import torch

from exploring_meta_tpu_torch.tasks.datasets import PackedDataset


def _rand(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device)


def _sample(gen, images, ways, shots, meta_batch, invert, rotations):
    n_cls, n_per = images.shape[0], images.shape[1]
    if n_cls < ways:
        raise ValueError(f"dataset split has {n_cls} classes < ways={ways}")
    if n_per < 2 * shots:
        raise ValueError(f"dataset has {n_per} samples/class < "
                         f"2*shots={2 * shots}")
    dev = images.device
    cls_ids = _rand(gen, (meta_batch, n_cls)).argsort(-1)[:, :ways].to(dev)
    smp_ids = _rand(gen, (meta_batch, ways, n_per)).argsort(-1)
    smp_ids = smp_ids[..., :2 * shots].to(dev)
    data = images[cls_ids[..., None], smp_ids]      # [B, ways, 2s, H, W, C]
    data = data.float() / 255.0
    if invert:
        data = 1.0 - data
    if rotations:
        rots = torch.randint(0, 4, (meta_batch, ways), generator=gen,
                             device=gen.device).to(dev)
        k = rots[:, :, None, None, None, None]
        out = data
        for r in (1, 2, 3):
            out = torch.where(k == r, torch.rot90(data, r, dims=(3, 4)), out)
        data = out
    data = data.reshape((meta_batch, ways * 2 * shots) + data.shape[3:])
    # class-major labels 0..ways-1, each 2*shots times; floor division
    # sizes nothing on the host (a CUDA graph can capture it)
    labels = torch.arange(ways * 2 * shots, device=dev) // (2 * shots)
    return data, labels.expand(meta_batch, -1)


def sample_task(gen: torch.Generator, images: torch.Tensor, ways: int,
                shots: int, invert: bool, rotations: bool):
    """One task from ``images [n_cls, n_per, H, W, C]`` (uint8) ->
    ``(data [ways*2*shots, H, W, C] float32, labels [ways*2*shots])``."""
    data, labels = _sample(gen, images, ways, shots, 1, invert, rotations)
    return data[0], labels[0]


def sample_task_batch(gen: torch.Generator, dataset: PackedDataset,
                      ways: int, shots: int, meta_batch: int):
    """-> ``(data [B, ways*2*shots, H, W, C], labels [B, ways*2*shots])``
    on the dataset's device."""
    return _sample(gen, dataset.images, ways, shots, meta_batch,
                   dataset.invert, dataset.rotations)


def split_support_query(data: torch.Tensor, labels: torch.Tensor,
                        shots: int, ways: int):
    """Even/odd interleave split along the example axis, the last axis of
    the labels (``[N]`` or ``[B, N]``; data ``[N, ...]`` or ``[B, N, ...]``,
    images or features): even indices are the support set, odd ones the
    query set."""
    idx = torch.arange(shots * ways, device=data.device) * 2
    ax = labels.ndim - 1
    support = (data.index_select(ax, idx), labels.index_select(ax, idx))
    query = (data.index_select(ax, idx + 1), labels.index_select(ax, idx + 1))
    return support, query
