"""Experiment harness: run dirs, metric logs, checkpoints that resume (port
of ``exploring_meta_tpu/utils/experiment.py``).

The run directory keeps the reference's artifact contract::

    <path>/<algo>_<dataset>_<date>_<seed>_<rand>/
        logger.json        config + metadata ('elapsed_time', 'final_eval',
                           'manually_stopped' / 'diverged')
        metrics.json       {metric_name: [values...]}
        model.npz          final params (flat {slash/path: array})
        model_checkpoints/model_<iter>.npz

Keys are slash paths (``base/0/conv/w``, ``mean/0/w``) exactly as the JAX
package writes them, and arrays keep the JAX layout, so a ``model.npz``
written by either package loads in the other.

A checkpoint may carry what a resume needs, under JAX's keys where JAX has
one:

- ``__opt__/0/count`` (int32), ``__opt__/0/mu/<path>``,
  ``__opt__/0/nu/<path>``: the Adam state, keyed as
  ``flatten_params(optax.adam(lr).init(params), prefix="__opt__/")``
  keys it (``step``, ``exp_avg`` and ``exp_avg_sq`` of
  ``torch.optim.Adam``), so each package loads the other's;
- ``__torch_rng__/<device type>``: the run's ``torch.Generator`` state.
  JAX's ``__rng__`` holds a threefry key, which no ``torch.Generator``
  can take, and JAX reads any ``__rng__`` as one; so neither package
  writes the other's key, and a resume across packages (or device types)
  restarts the random stream from the seed and says so;
- ``__iteration__``: the last iteration done.

``--ckpt_backend orbax`` writes ``torch.distributed.checkpoint`` step
directories instead (``utils/dcp_ckpt.py``), and ``--async_ckpt`` writes
npz checkpoints on one background thread.

Under ``--mesh N`` (``parallel/launch.py``) the trainer made by the caller
creates the run dir and launches N ranks, each running a copy of it; rank
0 alone writes into the run dir (summary, checkpoints, metrics, model,
logger, wandb), and the caller's trainer takes rank 0's metrics and logger
when the ranks are done.
"""

from __future__ import annotations

import datetime
import glob
import json
import os
import re

import numpy as np
import torch

from exploring_meta_tpu_torch.parallel.launch import current_rank
from exploring_meta_tpu_torch.utils.tree import tree_from_items, tree_items

OPT_PREFIX = "__opt__/"
RNG_PREFIX = "__torch_rng__/"


def flatten_params(tree, prefix: str = "") -> dict:
    """Params tree -> flat ``{slash/path: np.ndarray}`` (npz-serializable)."""
    return {prefix + key: leaf.detach().cpu().numpy()
            for key, leaf in tree_items(tree)}


def unflatten_into(tree, flat: dict, prefix: str = ""):
    """Inverse of :func:`flatten_params` given a structural template: each
    leaf takes the template leaf's dtype and device, and must match its
    shape."""
    def rebuild(key, leaf):
        arr = flat[prefix + key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{prefix + key}: shape {tuple(arr.shape)} != "
                             f"{tuple(leaf.shape)}")
        return torch.as_tensor(np.asarray(arr), dtype=leaf.dtype,
                               device=leaf.device)

    return tree_from_items((key, rebuild(key, leaf))
                           for key, leaf in tree_items(tree))


def load_params(path: str, template):
    """Load a ``model.npz`` / checkpoint into the structure of ``template``."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return unflatten_into(template, flat)


def list_checkpoints(run_dir: str) -> list:
    """Numerically sorted ``[(step, path)]`` of
    ``model_checkpoints/model_<step>.npz`` under ``run_dir`` (a
    lexicographic sort would put model_10 before model_2)."""
    out = []
    for path in glob.glob(os.path.join(run_dir, "model_checkpoints",
                                       "model_*.npz")):
        m = re.search(r"model_(\d+)\.npz$", path)
        if m:
            out.append((int(m.group(1)), path))
    return sorted(out)


def _leaf_paths(params) -> dict:
    return {id(leaf): key for key, leaf in tree_items(params)}


def _opt_params(opt, params):
    """-> ``[(path, leaf)]`` of the tensors ``opt`` steps, each a leaf of
    ``params`` (by identity)."""
    paths = _leaf_paths(params)
    out = []
    for group in opt.param_groups:
        for p in group["params"]:
            if id(p) not in paths:
                raise ValueError("the optimizer steps a tensor that is not "
                                 "a leaf of the params tree")
            out.append((paths[id(p)], p))
    return out


def adam_state(opt: torch.optim.Adam, params) -> dict:
    """``opt``'s state as optax's Adam keys ``0/count``, ``0/mu/<path>`` and
    ``0/nu/<path>`` -> ``{key: tensor}`` on the params' devices. An Adam
    that has not stepped holds count 0 and zero moments, as
    ``optax.adam(lr).init`` does."""
    out, count = {}, None
    for path, p in _opt_params(opt, params):
        st = opt.state.get(p) or {}
        if count is None:
            count = st.get("step", torch.zeros(()))
        out[f"0/mu/{path}"] = st.get("exp_avg", torch.zeros_like(p))
        out[f"0/nu/{path}"] = st.get("exp_avg_sq", torch.zeros_like(p))
    out["0/count"] = count
    return out


def load_adam_state(opt: torch.optim.Adam, params,
                    flat: dict) -> torch.optim.Adam:
    """Set ``step``, ``exp_avg`` and ``exp_avg_sq`` of every leaf ``opt``
    steps from optax's keys in ``flat`` (an Adam that has not stepped has
    none yet). ``step`` lies where torch keeps it: on the leaf's device for
    a ``capturable`` Adam, else on the CPU."""
    prefix = OPT_PREFIX
    count = float(np.asarray(flat[prefix + "0/count"]))
    scalar = (torch.float64 if torch.get_default_dtype() == torch.float64
              else torch.float32)
    capturable = {id(p): g["capturable"] or bool(g.get("fused"))
                  for g in opt.param_groups for p in g["params"]}

    def moment(key, p):
        arr = np.asarray(flat[key])
        if arr.shape != tuple(p.shape):
            raise ValueError(f"{key}: shape {arr.shape} != {tuple(p.shape)}")
        return torch.as_tensor(arr, dtype=p.dtype, device=p.device).clone()

    for path, p in _opt_params(opt, params):
        opt.state[p] = {
            "step": torch.tensor(count, dtype=scalar,
                                 device=p.device if capturable[id(p)]
                                 else "cpu"),
            "exp_avg": moment(f"{prefix}0/mu/{path}", p),
            "exp_avg_sq": moment(f"{prefix}0/nu/{path}", p)}
    return opt


def resume_state(params, opt=None, gen=None) -> dict:
    """What a checkpoint holds, as ``{key: tensor}`` under the npz keys
    (the iteration apart): the params, the Adam state and the generator's
    state."""
    flat = dict(tree_items(params))
    if opt is not None:
        flat.update({OPT_PREFIX + k: v
                     for k, v in adam_state(opt, params).items()})
    if gen is not None:
        flat[RNG_PREFIX + gen.device.type] = gen.get_state()
    return flat


def host_snapshot(tensors: dict):
    """Copy each tensor to the host in stream order -> ``(copies, event)``.

    A tensor on the card is copied without blocking into a pinned buffer
    and ``event`` is recorded after the copies: once it has completed the
    copies hold the values at the time of this call, whatever the card
    runs later (the trainers step their params in place). Nothing here
    waits for the card. CPU tensors are cloned (``event`` is None when no
    tensor is on the card)."""
    out, card = {}, None
    for key, t in tensors.items():
        t = t.detach()
        if t.device.type == "cuda":
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            out[key], card = buf, t.device
        else:
            out[key] = t.clone()
    event = None
    if card is not None:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(card))
    return out, event


def snapshot_arrays(host: dict, event) -> dict:
    """Wait for :func:`host_snapshot`'s copies -> ``{key: np.ndarray}``,
    the Adam count as int32, as optax keeps it."""
    if event is not None:
        event.synchronize()
    flat = {k: v.numpy() for k, v in host.items()}
    if OPT_PREFIX + "0/count" in flat:
        flat[OPT_PREFIX + "0/count"] = np.asarray(
            flat[OPT_PREFIX + "0/count"], np.float64).astype(np.int32)
    return flat


def state_from_flat(flat: dict, params_template, opt=None):
    """``{key: array}`` of a checkpoint -> ``(params, opt | None, generator
    state | None)``: the params in ``params_template``'s structure, dtypes
    and devices; ``opt`` loaded when the checkpoint has an Adam state; the
    ``torch.Generator`` state of the template's device type, if saved."""
    params = unflatten_into(params_template, flat)
    loaded = None
    if opt is not None and any(k.startswith(OPT_PREFIX) for k in flat):
        loaded = load_adam_state(opt, params_template, flat)
    dev = next(iter(tree_items(params_template)))[1].device.type
    state = flat.get(RNG_PREFIX + dev)
    if state is not None:
        state = torch.as_tensor(np.asarray(state), dtype=torch.uint8)
    return params, loaded, state


def load_checkpoint(path: str, params_template, opt=None):
    """-> ``(params, opt | None, generator state | None, iteration)``.

    ``path`` is a checkpoint ``.npz`` or a ``model_checkpoints/``
    directory written under ``--ckpt_backend orbax`` (its latest step;
    ``utils/dcp_ckpt.py``). A missing path raises."""
    if os.path.isdir(path):
        from exploring_meta_tpu_torch.utils.dcp_ckpt import (
            load_dcp_checkpoint,
        )
        return load_dcp_checkpoint(path, params_template, opt)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    params, loaded, state = state_from_flat(flat, params_template, opt)
    return params, loaded, state, int(flat.get("__iteration__", 0))


def resume_training(resume_path: str, params, opt=None, gen=None):
    """Mid-training resume shared by the trainers: restore the params (in
    place, so ``opt`` keeps stepping the same tensors), the Adam state when
    the checkpoint has one, and the generator -> ``(params, opt | None,
    gen, start_iteration)``. A checkpoint is written after its iteration,
    so the run continues at the next one. A checkpoint without this
    device type's generator state (a JAX one, or one from the other
    device type) restores the rest, and the stream restarts from the
    seed."""
    loaded, opt, state, done = load_checkpoint(resume_path, params, opt)
    with torch.no_grad():
        for (_, p), (_, q) in zip(tree_items(params), tree_items(loaded)):
            p.copy_(q)
    if gen is not None:
        if state is not None:
            gen.set_state(state)
        else:
            print(f"{resume_path} holds no {gen.device.type} generator "
                  "state: the random stream restarts from --seed")
    start = done + 1
    print(f"Resumed from {resume_path}: iteration {done} done, "
          f"continuing at {start}")
    return params, opt, gen, start


class DivergenceError(RuntimeError):
    """Raised by the watchdog when a logged ``*loss`` metric goes
    non-finite; trainers catch it beside KeyboardInterrupt and finish
    gracefully (mark the logger, save, evaluate)."""


class Experiment:
    """Logger/checkpointer each trainer inherits (reference Experiment)."""

    launches_ranks = False   # True: --mesh N runs the trainer in N ranks

    def __init__(self, algo: str, dataset: str, params: dict,
                 path: str = "results/", use_wandb: bool = False):
        params = dict(params)
        params["algo"] = algo
        params["dataset"] = dataset
        params.setdefault("seed", 42)
        self.params = params
        self.nan_guard = bool(params.get("nan_guard", True))

        # where the kernels build: --compile_cache (off: build/)
        from exploring_meta_tpu_torch.utils.compile_cache import (
            enable_compile_cache,
        )
        enable_compile_cache(params.get("compile_cache", ""))

        rng = np.random.default_rng()
        self.logger = {
            "config": self.params,
            "date": datetime.datetime.now().strftime("%d_%m_%Hh%M"),
            "model_id": f"{params['seed']}_{rng.integers(1, 9999)}",
        }
        self.metrics: dict = {}
        self.model_path = os.path.join(
            path, f"{algo}_{dataset}_{self.logger['date']}_"
                  f"{self.logger['model_id']}")
        # only rank 0 of a launched run writes (a trainer made outside a
        # launch is its own rank 0)
        rank = current_rank()
        self._writer = rank is None or rank.rank == 0
        if self._writer:
            os.makedirs(os.path.join(self.model_path, "model_checkpoints"))

        self._ckpt_executor = None
        self._ckpt_futures: list = []
        # "npz" (the default) or "orbax": torch.distributed.checkpoint step
        # directories (utils/dcp_ckpt.py); trainers set it from the config
        self.ckpt_backend = "npz"
        self._dcp = None

        self._use_wandb = False
        self._want_wandb = use_wandb
        # a trainer that will launch --mesh ranks leaves it to rank 0
        # (enter_rank)
        if use_wandb and self._writer and not (
                self.launches_ranks and rank is None
                and int(params.get("mesh", 1)) > 1):
            self._start_wandb()

    def _start_wandb(self) -> None:
        """Optional: wandb is not a dependency."""
        algo, dataset = self.params["algo"], self.params["dataset"]
        try:
            import wandb
            self._wandb = wandb.init(
                project="exploring_meta_tpu",
                id=f"{algo}_{dataset}_{self.logger['model_id']}",
                config=self.params, tags=[algo, dataset])
            self._use_wandb = True
        except Exception as e:
            print(f"wandb unavailable ({e}); continuing without it")

    def run_ranks(self):
        """``--mesh N`` from outside a launch: run this trainer in N ranks
        (``parallel/launch.py``; the CPU with gloo for ``device="cpu"``,
        else one card a rank with NCCL) -> rank 0's result. This trainer
        then holds rank 0's metrics and logger, and ``rank_counts`` each
        rank's launch counters."""
        from exploring_meta_tpu_torch.parallel.launch import launch
        from exploring_meta_tpu_torch.parallel.mesh import local_count
        n = self.params["mesh"]
        # a meta-batch the ranks cannot share raises before any is started
        local_count(n, self.params["meta_batch_size"])
        outs = launch(_run_rank, n, args=(self,), device=self.device)
        first = outs[0]["result"]
        self.metrics, self.logger = first["metrics"], first["logger"]
        self.rank_counts = [o["counts"] for o in outs]
        return first["value"]

    def enter_rank(self):
        """-> the task mesh of the launched rank this trainer runs in (the
        trainer moves to the rank's device; rank 0 starts wandb), or None
        outside a launch."""
        rank = current_rank()
        if rank is None:
            return None
        from exploring_meta_tpu_torch.parallel.mesh import make_task_mesh
        mesh = make_task_mesh()
        if int(self.params.get("mesh", 1)) != mesh.size:
            raise ValueError(f"--mesh {self.params.get('mesh', 1)} run in a "
                             f"launch of {mesh.size} ranks")
        self.device = mesh.device
        self._writer = mesh.rank == 0
        if self._writer and self._want_wandb and not self._use_wandb:
            self._start_wandb()
        return mesh

    def __getstate__(self):
        # a trainer is pickled into each launched rank, without its
        # wandb run and checkpoint threads
        state = dict(self.__dict__)
        state.pop("_wandb", None)
        state.update(_use_wandb=False, _ckpt_executor=None,
                     _ckpt_futures=[], _dcp=None)
        return state

    def log_metrics(self, metrics: dict, step: int | None = None) -> None:
        """Append each value to its metric's list (and send the row to
        wandb when it is on); raise :class:`DivergenceError` after
        appending a non-finite ``*loss`` (when ``nan_guard`` is on), so
        metrics.json keeps the evidence."""
        diverged = None
        for key, value in metrics.items():
            scalar = (float(value)
                      if np.isscalar(value) or hasattr(value, "item")
                      else value)
            self.metrics.setdefault(key, []).append(scalar)
            if (self.nan_guard and "loss" in key
                    and isinstance(scalar, float) and not np.isfinite(scalar)):
                diverged = (key, scalar)
        if self._use_wandb:
            self._wandb.log(metrics, step=step)
        if diverged is not None:
            raise DivergenceError(
                f"{diverged[0]} = {diverged[1]} at logged step "
                f"{len(self.metrics[diverged[0]]) - 1}")

    def mark_stopped(self, exc: BaseException,
                     iteration: int | None = None) -> None:
        """KeyboardInterrupt / DivergenceError bookkeeping of the graceful
        finish; ``iteration`` truncates the recorded ``num_iterations``."""
        if isinstance(exc, DivergenceError):
            print(f"\nTraining loss diverged ({exc}) - stopping, saving "
                  "state & evaluating...\n")
            self.logger["diverged"] = str(exc)
        else:
            print("\nManually stopped training! Start evaluation & "
                  "saving...\n")
            self.logger["manually_stopped"] = True
        if iteration is not None:
            self.params["num_iterations"] = iteration

    def log_model(self, params, name: str = "model") -> None:
        """Architecture summary, printed and written to ``<name>.summary``."""
        flat = flatten_params(params)
        lines = [f"{k}: shape={v.shape} params={v.size}"
                 for k, v in flat.items()]
        lines.append(f"TOTAL PARAMS: {sum(v.size for v in flat.values())}")
        info = "\n".join(lines)
        if not self._writer:
            return
        print(info)
        with open(os.path.join(self.model_path, f"{name}.summary"), "w") as f:
            f.write(info)

    def save_logs_to_file(self) -> None:
        """metrics.json and logger.json as strict JSON: a non-finite float
        (a diverged run's evidence) is written as null."""
        def finite(v):
            if isinstance(v, float) and not np.isfinite(v):
                return None
            if isinstance(v, dict):
                return {k: finite(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [finite(x) for x in v]
            return v

        if not self._writer:
            return
        with open(os.path.join(self.model_path, "metrics.json"), "w") as f:
            json.dump(finite(self.metrics), f)
        with open(os.path.join(self.model_path, "logger.json"), "w") as f:
            json.dump(finite(self.logger), f, sort_keys=True, indent=4,
                      default=str)

    def save_model(self, params, name: str = "model") -> None:
        if not self._writer:
            return
        np.savez(os.path.join(self.model_path, f"{name}.npz"),
                 **flatten_params(params))

    def save_model_checkpoint(self, params, iteration: int,
                              name: str = "model", opt_state=None, gen=None,
                              async_write: bool = False) -> None:
        """``model_checkpoints/<name>_<iteration>.npz``: the params, and
        what a resume needs: ``opt_state`` (the Adam, under optax's keys),
        ``gen``'s state and ``__iteration__``.

        The values are those at the time of the call: they are copied in
        stream order before anything later runs (:func:`host_snapshot`).
        ``async_write=True`` leaves the wait for the copies and the write
        to one background thread, so the training thread never waits for
        the card here; :meth:`flush_checkpoints` waits for the writes and
        re-raises a failed one. Under ``ckpt_backend == "orbax"`` the
        checkpoint is a DCP step directory under ``model_checkpoints/``
        (``utils/dcp_ckpt.py``, always written in the background)."""
        if not self._writer:
            return
        tensors = resume_state(params, opt_state, gen)
        if self.ckpt_backend == "orbax":
            if self._dcp is None:
                from exploring_meta_tpu_torch.utils.dcp_ckpt import (
                    DCPCheckpointer,
                )
                self._dcp = DCPCheckpointer(
                    os.path.join(self.model_path, "model_checkpoints"))
            self._dcp.save_flat(iteration, tensors)
            return
        out = os.path.join(self.model_path, "model_checkpoints",
                           f"{name}_{iteration}.npz")
        host, event = host_snapshot(tensors)

        def write():
            flat = snapshot_arrays(host, event)
            flat["__iteration__"] = np.asarray(int(iteration))
            np.savez(out, **flat)

        if async_write:
            if self._ckpt_executor is None:
                from concurrent.futures import ThreadPoolExecutor
                self._ckpt_executor = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="ckpt")
            self._ckpt_futures.append(self._ckpt_executor.submit(write))
        else:
            write()

    def flush_checkpoints(self) -> None:
        """Block until every background checkpoint write has landed
        (re-raising a failed one). Trainers call it before the final save
        and the meta-test."""
        futures, self._ckpt_futures = self._ckpt_futures, []
        for f in futures:
            f.result()
        if self._dcp is not None:
            self._dcp.wait()

    def save_acc_matrix(self, acc_matrix) -> None:
        """Write a CL accuracy matrix to ``acc_matrix.out`` in the run dir
        (two decimals, as the JAX package writes it)."""
        from exploring_meta_tpu_torch.analysis.cl import save_acc_matrix
        print("Saving accuracy matrix..")
        print(acc_matrix)
        save_acc_matrix(self.model_path, acc_matrix)


def _run_rank(trainer: Experiment) -> dict:
    """A launched rank's run of ``trainer`` (``Experiment.run_ranks``)."""
    value = trainer.run()
    return {"value": value, "metrics": trainer.metrics,
            "logger": trainer.logger}
