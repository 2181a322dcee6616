"""Inputs and weights made from the seed, on the device, in a few large
calls. Both the package under test and the reference are handed what is
made here; neither makes its own.
"""

from __future__ import annotations

import math

import torch

# offsets that keep the streams drawn from one seed apart
WEIGHTS, DATA, TASKS, RUN = 0, 1, 2, 3


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of the seed's draws."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 4 + stream) % (2 ** 63))
    return gen


def omniglot_images(gen: torch.Generator, classes: int, per_class: int,
                    size: int) -> torch.Tensor:
    """Synthetic Omniglot, ``[classes, per_class, size, size, 1]`` uint8: a
    smooth class pattern (four sines of drawn frequency and phase) plus
    N(0, 0.12) noise per image, clipped to [0, 1]; the shape of the
    reference's packed set."""
    dev = gen.device
    freq = 0.15 + 0.75 * torch.rand((classes, 4, 1, 1), generator=gen,
                                    device=dev)
    phase = 2 * math.pi * torch.rand((classes, 4, 1, 1), generator=gen,
                                     device=dev)
    yy, xx = torch.meshgrid(torch.arange(size, device=dev,
                                         dtype=torch.float32),
                            torch.arange(size, device=dev,
                                         dtype=torch.float32),
                            indexing="ij")
    coords = torch.stack([xx, xx + yy, xx, xx + yy])        # [4, H, W]
    base = torch.sin(freq * coords + phase).sum(dim=1)      # [C, H, W]
    lo = base.amin(dim=(1, 2), keepdim=True)
    hi = base.amax(dim=(1, 2), keepdim=True)
    base = (base - lo) / (hi - lo + 1e-6)
    noise = 0.12 * torch.randn((classes, per_class, size, size),
                               generator=gen, device=dev)
    imgs = ((base.unsqueeze(1) + noise).clamp(0, 1) * 255).to(torch.uint8)
    return imgs.unsqueeze(-1)


def distinct(gen: torch.Generator, rows: int, n: int, k: int,
             chunk: int = 8192) -> torch.Tensor:
    """``[rows, k]`` int64: ``k`` distinct values of ``range(n)`` a row,
    uniformly drawn (the first ``k`` of a random permutation)."""
    out = []
    for start in range(0, rows, chunk):
        m = min(chunk, rows - start)
        u = torch.rand((m, n), generator=gen, device=gen.device)
        out.append(u.topk(k, dim=-1).indices)
    return torch.cat(out)


def task_tables(gen: torch.Generator, batches: int, tasks: int, ways: int,
                classes: int, per_class: int, samples: int) -> tuple:
    """Index tables of ``batches`` task batches: ``classes [batches, tasks,
    ways]`` and, per class, ``samples`` distinct images ``[batches, tasks,
    ways, samples]``."""
    rows = batches * tasks
    cls = distinct(gen, rows, classes, ways).view(batches, tasks, ways)
    smp = distinct(gen, rows * ways, per_class, samples).view(
        batches, tasks, ways, samples)
    return cls, smp


def gather_tasks(images: torch.Tensor, cls: torch.Tensor,
                 smp: torch.Tensor) -> torch.Tensor:
    """Images of index tables ``[..., ways]`` / ``[..., ways, samples]`` ->
    float32 ``[..., ways, samples, H, W, C]`` in [0, 1], inverted as
    Omniglot is (strokes high)."""
    data = images[cls.unsqueeze(-1), smp]
    return 1.0 - data.float() / 255.0


def cnn4_params(gen: torch.Generator, cfg: dict) -> dict:
    """CNN4 weights in the package's layout (``{"base": [{"conv": {"w"
    HWIO, "b"}, "bn": {"scale", "bias"}}], "head": {"w", "b"}}``):
    xavier-uniform convs with zero bias, BN scale ~ U(0, 1) and zero
    shift, an N(0, 1) head with zero bias; float32."""
    dev, hid = gen.device, cfg["hidden"]
    base, ci = [], cfg["channels"]
    for _ in range(cfg["layers"]):
        a = math.sqrt(6.0 / (9 * ci + 9 * hid))
        w = (2 * torch.rand((3, 3, ci, hid), generator=gen, device=dev)
             - 1) * a
        base.append({"conv": {"w": w, "b": torch.zeros(hid, device=dev)},
                     "bn": {"scale": torch.rand(hid, generator=gen,
                                                device=dev),
                            "bias": torch.zeros(hid, device=dev)}})
        ci = hid
    head = {"w": torch.randn((hid, cfg["ways"]), generator=gen, device=dev),
            "b": torch.zeros(cfg["ways"], device=dev)}
    return {"base": base, "head": head}


def policy_params(gen: torch.Generator, cfg: dict) -> dict:
    """Gaussian MLP policy weights in the package's layout (``{"mean":
    [{"w" [in, out], "b"}], "sigma"}``): xavier-uniform weights, zero
    biases, log-sigma 0; float32."""
    dev = gen.device
    sizes = [cfg["obs_size"], *cfg["hiddens"], cfg["action_size"]]
    mean = []
    for i, o in zip(sizes[:-1], sizes[1:]):
        a = math.sqrt(6.0 / (i + o))
        mean.append({"w": (2 * torch.rand((i, o), generator=gen, device=dev)
                           - 1) * a,
                     "b": torch.zeros(o, device=dev)})
    return {"mean": mean,
            "sigma": torch.zeros(cfg["action_size"], device=dev)}
