"""The ranks of a task-data-parallel run (``--mesh N``).

JAX drives every chip of a mesh from one controller process. PyTorch runs
one process a device: :func:`launch` starts ``N`` ranks with
``torch.multiprocessing`` (start method ``spawn``), joins them into one
``torch.distributed`` process group, runs ``fn(*args)`` in each and
returns what each returned, with the launch counters it ended with.

- On cards rank ``r`` runs on ``cuda:r`` with NCCL; on the CPU
  (``device="cpu"``, ``EMT_FORCE_CPU=1``) every rank runs on the CPU with
  gloo. An explicit ``devices`` tuple may repeat a card (two ranks on one
  card), which NCCL refuses, so it takes ``backend="gloo"`` explicitly.
- The group meets through a ``FileStore`` in a fresh temporary directory,
  never a fixed TCP port, so concurrent launches cannot collide, and its
  collectives time out after ``TIMEOUT_S``.
- Each rank takes one intra-op thread before its first op.
- A rank that raises makes :func:`launch` raise within seconds: the other
  ranks are terminated, whatever collective they wait in.

Inside a rank, :func:`current_rank` says which rank it is and on which
device; ``parallel/mesh.py:make_task_mesh`` builds the mesh from it.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from typing import Callable, NamedTuple

import torch


class RankInfo(NamedTuple):
    rank: int
    size: int
    devices: tuple        # every rank's device, by rank
    backend: str          # "nccl" | "gloo"

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]


_RANK: RankInfo | None = None
# a collective that waits longer raises (a rank that died mid-collective
# makes the launch fail long before: its exit is seen at once)
TIMEOUT_S = 600.0


def current_rank() -> RankInfo | None:
    """This process's rank of a :func:`launch`, or None outside one."""
    return _RANK


def launch_counts() -> dict:
    """This process's launch counters: each kernel wrapper's launches and
    captured calls, the CUDA-graph captures and replays, the host envs'
    counts and the mesh's collectives."""
    from exploring_meta_tpu_torch.cuda import cnn4_cuda, gae_cuda
    from exploring_meta_tpu_torch.envs import host
    from exploring_meta_tpu_torch.parallel import mesh
    from exploring_meta_tpu_torch.utils import graphs
    return {"launches": {**cnn4_cuda.launch_counts(),
                         **gae_cuda.launch_counts()},
            "captured": {**cnn4_cuda.captured_counts(),
                         **gae_cuda.captured_counts()},
            "graphs": dict(graphs.COUNTS), "host": dict(host.COUNTS),
            "collectives": dict(mesh.COUNTS)}


def rank_devices(n: int, device=None) -> tuple:
    """The devices of ``n`` ranks: ``n`` CPUs for ``device="cpu"``, else
    ``cuda:0 .. cuda:n-1``, which must exist (JAX's ``make_task_mesh``
    message)."""
    from exploring_meta_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    if n < 1:
        raise ValueError(f"mesh needs >= 1 device, got {n}")
    if dev.type != "cuda":
        return (dev,) * n
    have = torch.cuda.device_count()
    if n > have:
        raise ValueError(f"requested a {n}-device mesh but only {have} "
                         "devices are available")
    return tuple(torch.device("cuda", i) for i in range(n))


def _backend(devices: tuple, backend: str | None) -> str:
    cuda = {d.type for d in devices} == {"cuda"}
    backend = backend or ("nccl" if cuda else "gloo")
    if backend == "nccl":
        if not cuda:
            raise ValueError("NCCL runs on cards only; the CPU takes gloo")
        if len(set(devices)) < len(devices):
            raise ValueError(f"NCCL takes one rank a card, not {devices}; "
                             "pass backend='gloo' to share a card")
    elif backend != "gloo":
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def _rank_main(rank: int, fn: Callable, args: tuple, devices: tuple,
               backend: str, store: str) -> None:
    global _RANK
    import torch.distributed as dist
    torch.set_num_threads(1)
    dev = devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(store, 'store')}",
        world_size=len(devices), rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _RANK = RankInfo(rank, len(devices), devices, backend)
    try:
        result = fn(*args)
        torch.save({"result": result, "counts": launch_counts()},
                   os.path.join(store, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
        _RANK = None


def launch(fn: Callable, n: int | None = None, args: tuple = (), *,
           device=None, devices=None, backend: str | None = None) -> list:
    """Run ``fn(*args)`` in ``n`` ranks (or one a device of ``devices``)
    -> ``[{"result": ..., "counts": launch_counts()}]`` by rank.

    ``fn`` and ``args`` are pickled into each spawned process, so ``fn``
    must be a module-level function of a module that imports cleanly
    there. Raises ``torch.multiprocessing.ProcessRaisedException`` (the
    failing rank's traceback) or ``ProcessExitedException`` when a rank
    fails."""
    import torch.multiprocessing as mp
    if devices is None:
        devices = rank_devices(n, device)
    devices = tuple(torch.device(d) for d in devices)
    if n is not None and n != len(devices):
        raise ValueError(f"{n} ranks on {len(devices)} devices")
    backend = _backend(devices, backend)
    store = tempfile.mkdtemp(prefix="emt_mesh_")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, args, devices, backend, store),
            nprocs=len(devices), join=False, start_method="spawn")
        while not ctx.join(grace_period=5):
            pass
        return [torch.load(os.path.join(store, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(len(devices))]
    finally:
        shutil.rmtree(store, ignore_errors=True)
