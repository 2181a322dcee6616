"""Checkpoints on ``torch.distributed.checkpoint``, ``--ckpt_backend
orbax`` (the port's counterpart of ``exploring_meta_tpu/utils/
orbax_ckpt.py``; orbax is a JAX library).

:class:`DCPCheckpointer` keeps the orbax checkpointer's contract: one
directory per step under ``model_checkpoints/`` (``<run>/model_checkpoints
/<step>/``), saves in the background, ``latest_step`` and ``restore``, and
``--resume <run>/model_checkpoints`` restores the latest step. A step
holds the npz checkpoint's keys (the params by slash path,
``__opt__/0/...`` and ``__torch_rng__/<device type>``).

A save copies its tensors to the host in stream order on the calling
thread (``experiment.host_snapshot``), and one writer thread waits for the
copies and runs ``dcp.save``; DCP's own ``async_save`` is not used, since
this is a single-process run with no process group. A step is written
into ``<step>.tmp`` and renamed, so a step directory is always whole.
A DCP directory and an orbax directory cannot be read by the other
package.
"""

from __future__ import annotations

import os
import re
import shutil
import warnings
from concurrent.futures import ThreadPoolExecutor

import torch

from exploring_meta_tpu_torch.utils.experiment import (
    host_snapshot, resume_state, snapshot_arrays, state_from_flat,
)


class DCPCheckpointer:
    """Background (step -> params / Adam / generator) checkpoint store in
    ``directory``."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        # the note DCP prints on every single-process call, no_dist or not
        warnings.filterwarnings("ignore", "torch.distributed is disabled",
                                UserWarning)
        self._executor = None
        self._futures: list = []

    # -- write -------------------------------------------------------------

    def save(self, step: int, params, opt_state=None, gen=None) -> None:
        """Save in the background; returns once the copies are queued
        (training may go on stepping its own tensors in place)."""
        self.save_flat(step, resume_state(params, opt_state, gen))

    def save_flat(self, step: int, tensors: dict) -> None:
        """:meth:`save` of ``{key: tensor}`` as ``experiment.resume_state``
        gives it."""
        host, event = host_snapshot(tensors)
        final = os.path.join(self.directory, str(int(step)))
        tmp = final + ".tmp"

        def write():
            # imported here: its first import takes ~0.5 s, which the
            # training thread need not wait for
            import torch.distributed.checkpoint as dcp

            flat = {k: torch.from_numpy(v)
                    for k, v in snapshot_arrays(host, event).items()}
            shutil.rmtree(tmp, ignore_errors=True)
            dcp.save(flat, checkpoint_id=tmp, no_dist=True)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)

        if self._executor is None:
            self._executor = ThreadPoolExecutor(max_workers=1,
                                                thread_name_prefix="dcp")
        self._futures.append(self._executor.submit(write))

    def wait(self) -> None:
        """Block until the pending saves are on disk (re-raising a failed
        one)."""
        futures, self._futures = self._futures, []
        for f in futures:
            f.result()

    # -- read --------------------------------------------------------------

    def steps(self) -> list:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if re.fullmatch(r"\d+", d)
                      and os.path.isdir(os.path.join(self.directory, d)))

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def load_flat(self, step=None) -> tuple:
        """-> ``({key: tensor}, step)`` of ``step`` (the latest when None):
        every tensor the step holds, at its saved shape and dtype."""
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint import FileSystemReader
        from torch.distributed.checkpoint.metadata import (
            TensorStorageMetadata,
        )

        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint steps under {self.directory}")
        path = os.path.join(self.directory, str(int(step)))
        meta = FileSystemReader(path).read_metadata().state_dict_metadata
        flat = {k: torch.empty(m.size, dtype=m.properties.dtype)
                for k, m in meta.items()
                if isinstance(m, TensorStorageMetadata)}
        dcp.load(flat, checkpoint_id=path, no_dist=True)
        return flat, int(step)

    def restore(self, params_template, opt=None, step=None):
        """-> ``(params, opt | None, generator state | None, step)``; a
        step saved without an Adam or generator state restores None for
        it."""
        flat, step = self.load_flat(step)
        params, loaded, state = state_from_flat(
            {k: v.numpy() for k, v in flat.items()}, params_template, opt)
        return params, loaded, state, step


def load_dcp_checkpoint(path: str, params_template, opt=None):
    """The latest step of ``path``, with ``experiment.load_checkpoint``'s
    signature -> ``(params, opt | None, generator state | None,
    iteration)``."""
    if not os.path.isdir(path):
        raise FileNotFoundError(path)
    return DCPCheckpointer(path).restore(params_template, opt)
