"""Second-order MAML meta-training, fused: ``adapt/maml.py``'s
``make_train_scan`` replays one captured meta-iteration (32 tasks'
inner step and query loss, the meta-gradient through the inner step,
Adam), in chunks. Each iteration's task batch is drawn on the device by
the benchmark's ``sample_fn`` from index tables made from the seed, so
every batch is known to the check.

Set-up builds the one training object, drives its first ``follow_steps``
iterations one at a time (the first eager, then the capture and
replays), keeping what the check compares, and hands it to the window.

Traffic keys: ``meta_batch``, ``chunk`` (iterations a call),
``task_batches`` (rows of the index tables, used in turn),
``follow_steps``, ``profile_steps`` (chunks in the traced stretch).
"""

from __future__ import annotations

import math

import torch

from portbench import roofline, synth
from portbench.drivers.common import (
    Driver as Base, gap, in_place_of_program, leaf_gaps, leaf_norm_gaps,
    port_precision, rel_l2, sign_flips,
)
from portbench.reference import cnn4 as ref
from portbench.reference.precision import Precision, control_precision


class Driver(Base):
    unit = "iterations"

    def setup(self) -> None:
        with self.phase("import_port"):
            from exploring_meta_tpu_torch.adapt.maml import (
                adam, cast_compute, make_train_scan,
            )
            from exploring_meta_tpu_torch.adapt.vision import (
                make_vision_fast_adapt,
            )
            from exploring_meta_tpu_torch.models.cnn4 import CNN4Spec
        port_precision()
        c, t, dev = self.cfg, self.traffic, self.device
        with self.phase("data"):
            self.params0 = synth.cnn4_params(
                synth.generator(self.seed, synth.WEIGHTS, dev), c)
            self.images = synth.omniglot_images(
                synth.generator(self.seed, synth.DATA, dev), c["classes"],
                c["per_class"], c["image_size"])
            self.cls, self.smp = synth.task_tables(
                synth.generator(self.seed, synth.TASKS, dev),
                t["task_batches"], t["meta_batch"], c["ways"], c["classes"],
                c["per_class"], 2 * c["shots"])
        self.counter = torch.zeros((), dtype=torch.long, device=dev)
        spec = CNN4Spec(channels=c["channels"], hidden=c["hidden"],
                        layers=c["layers"], max_pool=False,
                        head_in=c["hidden"], ways=c["ways"],
                        image_size=c["image_size"], head_init="normal",
                        global_pool=True)
        fa = make_vision_fast_adapt(spec, c["inner_lr"], c["adapt_steps"],
                                    c["shots"], c["ways"])
        if c["compute_dtype"] != "float32":
            fa = cast_compute(fa, getattr(torch, c["compute_dtype"]))
        self.params = {"base": [{g: {k: v.clone().requires_grad_()
                                     for k, v in b[g].items()}
                                 for g in ("conv", "bn")}
                                for b in self.params0["base"]],
                       "head": {k: v.clone().requires_grad_()
                                for k, v in self.params0["head"].items()}}
        self.opt = adam(self.params, c["outer_lr"])
        self.gen = synth.generator(self.seed, synth.RUN, dev)
        self.train = make_train_scan(fa, self.sample, t["chunk"])
        self.follow()

    def batch_of(self, k):
        """Task batch ``k`` of the tables (``k`` a device scalar) in the
        layout ``sample_task_batch`` gives: class-major, support and query
        interleaved."""
        c = self.cfg
        cls = self.cls.index_select(0, k.view(1))[0]
        smp = self.smp.index_select(0, k.view(1))[0]
        data = synth.gather_tasks(self.images, cls, smp)
        B = data.shape[0]
        data = data.reshape((B, c["ways"] * 2 * c["shots"])
                            + data.shape[-3:])
        labels = torch.arange(c["ways"] * 2 * c["shots"],
                              device=data.device) // (2 * c["shots"])
        return data, labels.expand(B, -1)

    def sample(self, gen):
        """The ``sample_fn`` of the train scan: the next task batch of the
        tables, chosen by a device counter (no host sync, so a replay
        draws the next one)."""
        k = self.counter % self.cls.shape[0]
        self.counter.add_(1)
        return self.batch_of(k)

    def follow(self) -> None:
        """The first iterations, one call each, keeping each loss, the
        first gradient as Adam holds it after one step and the params
        after the last."""
        self.losses = []
        for step in range(self.traffic["follow_steps"]):
            # step 1 runs eagerly, step 2 is captured, then replays
            with self.phase(f"step_{step + 1}"):
                _, _, m = self.train(self.params, self.opt, self.gen, n=1)
            self.losses.append(float(m["loss"][0]))
            if step == 0:
                # exp_avg = (1 - b1) g after one step from zero
                self.first_grad = [
                    self.opt.state[p].get("exp_avg", torch.zeros_like(p))
                    .detach() / 0.1 for _, p in ref.leaves(self.params)]
        self.after = [p.detach().clone() for _, p in ref.leaves(self.params)]
        self.sync()

    def step(self) -> int:
        n = self.traffic["chunk"]
        _, _, m = self.train(self.params, self.opt, self.gen, n=n)
        losses = m["loss"].tolist()      # the sync
        self.failed += sum(not math.isfinite(v) for v in losses)
        return n

    def end_to_end(self, window: dict) -> dict:
        if not window["units"]:
            return {}
        return {"train_tasks_per_s": self.traffic["meta_batch"]
                * window["units"] / window["seconds"]}

    def unit_flops(self) -> float:
        return self.traffic["meta_batch"] * roofline.maml_task_flops(
            self.cfg)

    def dtype(self) -> str:
        return self.cfg["compute_dtype"]

    def kernel_bound_s(self) -> float:
        return roofline.maml_iteration_kernel_bound(
            self.cfg, self.traffic["meta_batch"], self.cfg["compute_dtype"])

    def release(self) -> None:
        self.train = self.opt = None
        self.params = None

    def followed_batches(self) -> list:
        c = self.cfg
        out = []
        for k in range(self.traffic["follow_steps"]):
            data, labels = self.batch_of(
                torch.tensor(k, device=self.images.device))
            s = torch.arange(c["ways"] * c["shots"],
                             device=data.device) * 2
            out.append((data[:, s], labels[:, s], data[:, s + 1],
                        labels[:, s + 1]))
        return out

    def readings(self, variant: str) -> dict:
        """The followed iterations against the reference's (float64):
        each step's loss (gap over the reference's); the first gradient's
        and the params' change's norms by the worst leaf (``first_grad``,
        ``change``) and by the median leaf (``_med``); the first gradient's
        relative error as a whole (``grad_rel``). For the look at what
        moves ``change``: the share of the first gradient's elements whose
        sign, and so Adam's first step, differs from the reference's
        (``flip_share``), the largest reference gradient among them over
        its leaf's root mean square (``flip_g_max``), and the size of the
        leaf with the worst change (``change_worst_numel``)."""
        batches = self.followed_batches()
        exact = Precision("float64")
        losses, grad, after = ref.meta_train(self.params0, batches,
                                             self.cfg, exact)
        other = in_place_of_program(variant, control_precision(self.cfg))
        if other is not None:
            got_losses, got_grad, got_after = ref.meta_train(
                self.params0, batches, self.cfg, other)
            got_after = got_after[-1]
        else:
            got_losses, got_grad, got_after = (self.losses, self.first_grad,
                                               self.after)
        start = [t.detach() for _, t in ref.leaves(self.params0)]
        out = {f"loss_{i + 1}": gap(g, w, abs(w))
               for i, (g, w) in enumerate(zip(got_losses, losses))}
        d_got = [a.double() - s.double() for a, s in zip(got_after, start)]
        d_want = [a.double() - s.double() for a, s in zip(after[-1], start)]
        out["first_grad"] = leaf_norm_gaps(got_grad, grad, grad)
        out["first_grad_med"] = leaf_norm_gaps(got_grad, grad, grad,
                                               worst=False)
        out["grad_rel"] = rel_l2(got_grad, grad)
        out["change"] = leaf_norm_gaps(d_got, d_want, grad)
        out["change_med"] = leaf_norm_gaps(d_got, d_want, grad, worst=False)
        out["flip_share"], out["flip_g_max"] = sign_flips(got_grad, grad,
                                                          grad)
        out["change_worst_numel"] = d_want[
            leaf_gaps(d_got, d_want, grad)[-1][1]].numel()
        return out
