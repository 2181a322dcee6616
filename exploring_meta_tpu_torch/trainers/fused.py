"""Shared driver for chunked fused training, ``--fuse N`` (port of
``exploring_meta_tpu/trainers/fused.py``).

Both trainers run the same loop around their fused iterations
(:class:`exploring_meta_tpu_torch.utils.graphs.FusedIterations`): run
``min(fuse, remaining)`` iterations as one chunk, fetch the chunk's
per-iteration metrics to the host in one copy, log them, and checkpoint
when a ``save_every`` boundary falls inside the chunk. The run's
``torch.Generator`` takes the place of JAX's per-chunk key split: each
chunk draws from where the last one stopped, so no stream is drawn twice.
"""

from __future__ import annotations

from typing import Callable

import torch

from exploring_meta_tpu_torch.utils.profiling import no_phase
from exploring_meta_tpu_torch.utils.tree import tree_map


def fetch(metrics: dict) -> dict:
    """``{name: [n] tensor}`` -> ``{name: [n] float32 numpy}`` in one
    device-to-host copy."""
    keys = list(metrics)
    host = torch.stack([metrics[k].detach().to(torch.float32)
                        for k in keys]).cpu().numpy()
    return dict(zip(keys, host))


def host_metrics(metrics: dict) -> dict:
    """One iteration's metrics with every tensor value fetched to the host
    in one copy (a Python number passes through as it is)."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    out = dict(metrics)
    if keys:
        vals = torch.stack([metrics[k].detach().to(torch.float32).reshape(())
                            for k in keys]).tolist()
        out.update(zip(keys, vals))
    return out


def snapshot(params):
    """A detached copy of a params tree: what a trainer keeps after each
    chunk, since the fused loop steps its params in place."""
    return tree_map(lambda t: t.detach().clone(), params)


def drive_fused_chunks(*, total: int, fuse: int, save_every: int, gen,
                       state, run_chunk: Callable, log_step: Callable,
                       save_ckpt: Callable, postfix: Callable | None = None,
                       progress=None, on_chunk: Callable | None = None,
                       start: int = 0):
    """Run ``total - start`` iterations in fused chunks.

    - ``run_chunk(n, state, gen) -> (state, metrics)`` with metrics leaves
      ``[n]`` tensors;
    - ``log_step(metrics, j)`` records iteration ``j`` of the chunk (the
      metrics fetched to the host, :func:`fetch`);
    - ``postfix(metrics) -> dict`` feeds ``progress.set_postfix`` where a
      ``progress`` bar (``update(n)``, ``set_postfix(d)``) is given; the
      trainers print their rows instead;
    - ``save_ckpt(state, iteration, gen)`` checkpoints at boundaries
      (fused checkpoints land on chunk-end iterations);
    - ``on_chunk(state, iteration)`` runs after every chunk: the hook for
      KeyboardInterrupt-safe progress tracking on the trainer.

    Returns ``(state, last_iteration, gen)``.
    """
    it, iteration = start, max(start - 1, 0)
    while it < total:
        n = min(fuse, total - it)
        state, ms = run_chunk(n, state, gen)
        ms = fetch(ms)
        for j in range(n):
            log_step(ms, j)
        it += n
        iteration = it - 1
        if on_chunk is not None:
            on_chunk(state, iteration)
        if progress is not None:
            progress.update(n)
            progress.set_postfix(postfix(ms))
        if (it // save_every) > ((it - n) // save_every):
            save_ckpt(state, iteration, gen)
    return state, iteration, gen


def run_fused(trainer, run_chunk: Callable, state, gen,
              names: dict | None = None, start: int = 0,
              phase: Callable = no_phase) -> int:
    """A trainer's whole run from iteration ``start`` in chunks of
    ``trainer.cfg.fuse``: each iteration's metrics (renamed by ``names``)
    printed and logged, checkpoints at chunk ends with the Adam state
    (``state[1]``, None for TRPO) and the generator, each chunk timed as
    JAX's ``train_chunk`` phase under ``--profile`` -> the last iteration.
    The params after the last whole chunk, and the count of iterations
    done in whole chunks (= rows of metrics.json), stay on
    ``trainer._fused_params`` / ``trainer._fused_count`` for an
    interrupt."""
    cfg, names = trainer.cfg, names or {}
    trainer._fused_params, trainer._fused_count = snapshot(state[0]), start

    def chunk(n, state, g):
        with phase("train_chunk") as sync:
            state, ms = run_chunk(n, state, g)
            sync.append(ms)
        return state, ms

    def log_step(ms, j):
        metrics = {names.get(k, k): float(v[j]) for k, v in ms.items()}
        if trainer._writer:
            print(f"iteration {trainer._fused_count + j}: {metrics}",
                  flush=True)
        trainer.log_metrics(metrics)

    def on_chunk(state, iteration):
        trainer._fused_params = snapshot(state[0])
        trainer._fused_count = iteration + 1

    state, iteration, _ = drive_fused_chunks(
        total=cfg.num_iterations, fuse=cfg.fuse, save_every=cfg.save_every,
        gen=gen, state=state, run_chunk=chunk, log_step=log_step,
        save_ckpt=lambda state, i, g: trainer.save_model_checkpoint(
            state[0], i, opt_state=state[1], gen=g,
            async_write=cfg.async_ckpt),
        on_chunk=on_chunk, start=start)
    trainer._fused_params = state[0]
    return iteration
