"""What every driver shares: the base class, the port's precision and
kernel selection, and the comparison measures."""

from __future__ import annotations

import contextlib
import time

import torch


class Driver:
    """A cell's program under test. ``step()`` does one unit of traffic
    (a served call or a chunk of iterations) and ends in a synchronize,
    returning the work it completed; ``profiled()`` is the traced
    stretch; ``readings(variant)`` the numbers compared with the
    reference."""

    failed = 0

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic = cfg, traffic
        self.seed, self.device = int(seed), device
        self.host_s: list = []          # each call's host time before sync
        self.phases: dict = {}          # seconds of each part of set-up

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Times a part of set-up, ended by a synchronize."""
        t0 = time.perf_counter()
        yield
        self.sync()
        self.phases[name] = time.perf_counter() - t0

    def profiled(self) -> int:
        units = 0
        for _ in range(int(self.traffic["profile_steps"])):
            units += self.step()
        return units

    def release(self) -> None:
        """Frees the program's state; what ``readings`` needs stays."""

    def end_to_end(self, window: dict) -> dict:
        raise NotImplementedError

    def readings(self, variant: str) -> dict:
        raise NotImplementedError


def port_precision() -> None:
    """The port's own switches, as the configurations state them:
    float32 products at full precision (TF32 off) and the CNN4 base on
    the port's fused kernels."""
    from exploring_meta_tpu_torch.models import layers
    layers.set_precision("highest")
    layers.set_conv_impl("fused")


def in_place_of_program(variant: str, control: str):
    """The reference's precision that stands in the program's place for
    ``variant``: None for the program itself, the control's for
    ``control``, else the precision it names."""
    from portbench.reference.precision import Precision
    if variant == "program":
        return None
    return Precision(control if variant == "control" else variant)


def slot_sample(seed: int, kept: int, batch: int, per_slot: int) -> list:
    """``(kept call, slot)`` pairs of the answers a check compares: every
    slot of a call ``per_slot`` times, each time in a kept call drawn from
    the seed, so that a fault in any one slot is in the sample."""
    gen = torch.Generator().manual_seed(seed)
    return [(int(torch.randint(kept, (1,), generator=gen)), r)
            for r in range(batch) for _ in range(per_slot)]


def gap(got: float, want: float, scale: float) -> float:
    return abs(got - want) / scale


def kept_leaves(grads: list) -> list:
    """Indices of the leaves whose reference gradient is at least a
    thousandth of the median leaf's; the others move by round-off alone."""
    rn = [float(g.double().norm()) for g in grads]
    med = sorted(rn)[len(rn) // 2]
    return [i for i in range(len(rn)) if rn[i] >= 1e-3 * med]


def leaf_gaps(got: list, want: list, grads: list) -> list:
    """``(gap, leaf)`` of the kept leaves (:func:`kept_leaves`), in
    order: ``| |got_i| - |want_i| |`` over the larger of ``|want_i|`` and
    the median leaf's ``|want|``."""
    gn = [float(g.double().norm()) for g in got]
    wn = [float(w.double().norm()) for w in want]
    keep = kept_leaves(grads)
    med_w = sorted(wn[i] for i in keep)[len(keep) // 2]
    return sorted((abs(gn[i] - wn[i]) / max(wn[i], med_w, 1e-30), i)
                  for i in keep)


def leaf_norm_gaps(got: list, want: list, grads: list,
                   worst: bool = True) -> float:
    """The worst kept leaf's gap between two norms (the median leaf's
    with ``worst=False``), as :func:`leaf_gaps`."""
    gaps = leaf_gaps(got, want, grads)
    return gaps[-1][0] if worst else gaps[len(gaps) // 2][0]


def sign_flips(got: list, want: list, grads: list) -> tuple:
    """Of the kept leaves' elements: the share whose sign differs between
    ``got`` and ``want`` (a first gradient), and the largest ``|want|``
    among them over its leaf's root mean square."""
    flipped = total = 0
    g_max = 0.0
    for i in kept_leaves(grads):
        g, w = got[i].double(), want[i].double()
        bad = torch.sign(g) != torch.sign(w)
        flipped += int(bad.sum())
        total += w.numel()
        if bool(bad.any()):
            rms = float(w.square().mean().sqrt())
            g_max = max(g_max, float(w[bad].abs().max()) / max(rms, 1e-30))
    return flipped / max(total, 1), g_max


def rel_l2(got: list, want: list) -> float:
    """``|got - want| / |want|`` over all leaves together."""
    num = sum(float((g.double() - w.double()).square().sum())
              for g, w in zip(got, want))
    den = sum(float(w.double().square().sum()) for w in want)
    return (num / den) ** 0.5
