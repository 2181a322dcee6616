"""MAML/ANIL few-shot vision trainer (port of
``exploring_meta_tpu/trainers/vision.py``; reference
``vision/maml_vision.py`` / ``vision/anil_vision.py``).

Each iteration samples a training and a validation meta-batch,
meta-evaluates the validation batch on the pre-update params, then takes
one second-order meta-step (Adam) on the training batch, and logs
``train_loss``, ``train_acc``, ``valid_loss`` and ``valid_acc``. After the
last iteration (or a KeyboardInterrupt, or a diverged loss) it saves the
model and meta-tests it on the test split. On the Omniglot spec under
``conv_impl="fused"`` (the default) the base runs on the fused CNN4 CUDA
kernels, forward and backward, under a backward that is itself
differentiable (``cuda/cnn4_cuda.py:FusedBlockBackward``).

``--fuse N`` runs the iterations in chunks of N (``adapt/maml.py:
make_train_scan``): on the card one iteration, the valid pass included, is
captured as a CUDA graph and replayed, a chunk's metrics come to the host
in one copy, and checkpoints land on chunk-end iterations
(``trainers/fused.py``).

The run utilities are JAX's, as in ``trainers/rl.py``: ``--resume``
(params, Adam state and generator), ``--async_ckpt``, ``--ckpt_backend
orbax`` (DCP), ``--profile`` (the phases ``sample``, ``valid_eval``,
``meta_step`` and, fused, ``train_chunk``), ``--trace`` and ``--wandb``.

``--mesh N`` runs the meta-batch task-data-parallel over N ranks
(``parallel/launch.py``, ``parallel/mesh.py``), with JAX's semantics: each
eager iteration every rank draws the same global batch from the shared
generator, keeps its contiguous shard for the meta-step (the gradients
averaged over the ranks) and meta-evaluates the whole valid batch; fused,
each rank samples ``meta_batch / N`` training and valid tasks from its own
generator (``parallel/mesh.py:rank_generator``) and both passes are
averaged. Rank 0 alone writes the run dir and meta-tests.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from exploring_meta_tpu_torch.adapt.maml import (
    adam, cast_compute, make_meta_eval, make_meta_step, make_train_scan,
)
from exploring_meta_tpu_torch.adapt.vision import make_vision_fast_adapt
from exploring_meta_tpu_torch.device import resolve_device
from exploring_meta_tpu_torch.models import cnn4
from exploring_meta_tpu_torch.models.layers import set_conv_impl
from exploring_meta_tpu_torch.parallel.launch import current_rank
from exploring_meta_tpu_torch.parallel.mesh import (
    local_count, make_sharded_meta_step, rank_generator, shard_task_batch,
)
from exploring_meta_tpu_torch.tasks.datasets import get_dataset
from exploring_meta_tpu_torch.tasks.sampler import sample_task_batch
from exploring_meta_tpu_torch.trainers.fused import host_metrics, run_fused
from exploring_meta_tpu_torch.utils.config import CONV_IMPLS, VisionConfig
from exploring_meta_tpu_torch.utils.experiment import (
    DivergenceError, Experiment, resume_training,
)
from exploring_meta_tpu_torch.utils.profiling import (
    PhaseTimer, device_trace, no_phase,
)
from exploring_meta_tpu_torch.utils.tree import tree_map


def _build_spec(cfg: VisionConfig, anil: bool) -> cnn4.CNN4Spec:
    if cfg.dataset == "omni":
        return (cnn4.anil_omniglot_spec(cfg.ways) if anil
                else cnn4.omniglot_spec(cfg.ways))
    if cfg.dataset == "min":
        return (cnn4.anil_mini_imagenet_spec(cfg.ways) if anil
                else cnn4.mini_imagenet_spec(cfg.ways))
    raise SystemExit(f"Dataset not supported: {cfg.dataset}")


class VisionTrainer(Experiment):
    """The meta-training loop of MAML or ANIL vision.

    ``device`` defaults to the card; pass ``device="cpu"`` to train on the
    CPU. Without a card the default raises before any run dir is made."""

    launches_ranks = True

    def __init__(self, cfg: VisionConfig, anil: bool = False,
                 path: str = "results/", device=None):
        self.device = resolve_device(device)
        algo = "anil" if anil else "maml"
        super().__init__(f"{algo}_{cfg.ways}w{cfg.shots}s", cfg.dataset,
                         cfg.to_params(), path=path, use_wandb=cfg.use_wandb)
        self.cfg = cfg
        self.anil = anil
        self.ckpt_backend = cfg.ckpt_backend

    def _fused_loop(self, fast_adapt, sample_train, sample_valid, params,
                    opt, gen, start: int = 0, phase=no_phase,
                    mesh=None) -> int:
        """All iterations in chunks of ``cfg.fuse`` (``make_train_scan``:
        the valid pass on the pre-update params, then the meta-step;
        ``trainers/fused.py:run_fused``) -> the last iteration. With a
        ``mesh`` each rank samples from its own generator."""
        train = make_train_scan(fast_adapt, sample_train, self.cfg.fuse,
                                eval_sample_fn=sample_valid, mesh=mesh)
        rank_gen = rank_generator(mesh, gen, self.cfg.seed, start)

        def run_chunk(n, state, g):
            p, o, ms = train(*state, rank_gen, n)
            return (p, o), ms

        return run_fused(self, run_chunk, (params, opt), gen, names={
            "loss": "train_loss", "metric": "train_acc",
            "valid_metric": "valid_acc"}, start=start, phase=phase)

    def run(self) -> float | None:
        """-> the meta-test accuracy (None on a launched rank but 0)."""
        if self.cfg.mesh > 1 and current_rank() is None:
            return self.run_ranks()
        mesh = self.enter_rank()
        cfg, dev = self.cfg, self.device
        train_ds, valid_ds, test_ds = get_dataset(
            cfg.dataset, seed=cfg.seed, synthetic=cfg.synthetic or None,
            synth_classes=cfg.synth_classes,
            synth_per_class=cfg.synth_per_class, device=dev)
        # Always set it: an earlier trainer in this process may have left
        # the module default on another lowering.
        set_conv_impl(CONV_IMPLS.get(cfg.conv_impl, cfg.conv_impl))

        spec = _build_spec(cfg, self.anil)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        params = tree_map(lambda t: t.requires_grad_(),
                          cnn4.init_cnn4(gen, spec, device=dev))
        self.log_model(params)
        fast_adapt = make_vision_fast_adapt(
            spec, inner_lr=cfg.inner_lr, adapt_steps=cfg.adapt_steps,
            shots=cfg.shots, ways=cfg.ways, anil=self.anil,
            remat_body=cfg.remat_body)
        if cfg.bf16:
            # bf16 compute graph, f32 master params and Adam state
            fast_adapt = cast_compute(fast_adapt)
        opt = adam(params, cfg.outer_lr)
        meta_eval = make_meta_eval(fast_adapt)
        if mesh is None:
            meta_step, place = make_meta_step(fast_adapt), lambda b: b
        else:
            local = local_count(mesh.size, cfg.meta_batch_size)
            meta_step = make_sharded_meta_step(fast_adapt, mesh)
            place = lambda b: shard_task_batch(mesh, b)  # noqa: E731

        def sample(ds, g=gen, n=cfg.meta_batch_size):
            return sample_task_batch(g, ds, cfg.ways, cfg.shots, n)

        start_iteration = 0
        if cfg.resume:
            # in place, before the first chunk: a capture takes the loaded
            # tensors (the Adam state is loaded into opt when saved)
            params, _, gen, start_iteration = resume_training(
                cfg.resume, params, opt, gen)
        timer = PhaseTimer() if cfg.profile else None
        ph = timer.phase if timer else no_phase

        start = time.perf_counter()
        iteration = start_iteration
        trace = (device_trace(cfg.trace) if cfg.trace and self._writer
                 else contextlib.nullcontext())
        try:
            with trace:
                if cfg.fuse > 1:
                    # with a mesh, each rank's share from its generator
                    n = cfg.meta_batch_size if mesh is None else local
                    iteration = self._fused_loop(
                        fast_adapt, lambda g: sample(train_ds, g, n),
                        lambda g: sample(valid_ds, g, n), params, opt, gen,
                        start=start_iteration, phase=ph, mesh=mesh)
                    params = self._fused_params
                else:
                    for iteration in range(start_iteration,
                                           cfg.num_iterations):
                        with ph("sample") as sync:
                            batch = place(sample(train_ds))
                            sync.append(batch)
                        with ph("valid_eval") as sync:
                            # PRE-update params: the reference's valid
                            # pass runs before opt.step()
                            # (maml_vision.py:117-141)
                            valid_m = meta_eval(params, *sample(valid_ds))
                            sync.append(valid_m)
                        with ph("meta_step") as sync:
                            params, opt, train_m = meta_step(params, opt,
                                                             *batch)
                            sync.append(train_m)
                        metrics = host_metrics({
                            "train_loss": train_m["loss"],
                            "train_acc": train_m["metric"],
                            "valid_loss": valid_m["loss"],
                            "valid_acc": valid_m["metric"]})
                        if self._writer:
                            print(f"iteration {iteration}: {metrics}",
                                  flush=True)
                        self.log_metrics(metrics)
                        if iteration % cfg.save_every == 0:
                            self.save_model_checkpoint(
                                params, iteration, opt_state=opt, gen=gen,
                                async_write=cfg.async_ckpt)
        except (KeyboardInterrupt, DivergenceError) as stop:
            if cfg.fuse > 1:
                # the COUNT of iterations in whole chunks (= rows of
                # metrics.json before the stop) and their params
                iteration, params = self._fused_count, self._fused_params
            self.mark_stopped(stop, iteration)

        self.flush_checkpoints()
        self.save_model(params)
        self.logger["elapsed_time"] = (
            f"{round(time.perf_counter() - start, 2)} sec")
        if timer and self._writer:
            timer.save(os.path.join(self.model_path, "phase_times.json"))
            print("Phase times:", timer.summary())

        if mesh is not None and mesh.rank:
            return None
        # the generator only moves forward: the meta-test draws numbers that
        # no training iteration (eager or replayed) drew
        test_acc = float(meta_eval(params, *sample(test_ds))["metric"])
        print("Meta Test Accuracy", test_acc)
        self.logger["test_acc"] = test_acc
        self.log_metrics({"test_acc": test_acc})
        self.save_logs_to_file()
        return test_acc
