"""Meta-RL policy serving: a closed loop of one caller, each call a batch
of tasks through ``PolicyServer.adapt_batched`` (``serve.py``), each task
a support set of collected episodes from a pool made from the seed. A
call ends when the adapted params are ready.

The support sets are rollouts of the meta-params on goals drawn from the
seed, made by the reference's rollout in float32.

Traffic keys: ``algo`` (the inner step), ``batch`` (tasks a call),
``episodes``, ``horizon``, ``pool`` (distinct batches, used in turn),
``keep_every`` (prime to ``pool``, so that the kept calls go through every
batch of it), ``check_requests`` (a whole number of times ``batch``),
``profile_steps``.
"""

from __future__ import annotations

import time

import torch

from portbench import roofline, synth
from portbench.drivers.common import (
    Driver as Base, in_place_of_program, port_precision, slot_sample,
)
from portbench.drivers.rl_common import policy_leaves, port_objects
from portbench.reference import particles as ref
from portbench.reference.precision import Precision, control_precision


class Driver(Base):
    unit = "requests"

    def setup(self) -> None:
        with self.phase("import_port"):
            from exploring_meta_tpu_torch.serve import PolicyServer
        port_precision()
        c, t, dev = self.cfg, self.traffic, self.device
        policy, rl_cfg = port_objects(c, t["episodes"], t["horizon"])
        with self.phase("data"):
            self.params0 = synth.policy_params(
                synth.generator(self.seed, synth.WEIGHTS, dev), c)
            gen = synth.generator(self.seed, synth.DATA, dev)
            n = t["pool"] * t["batch"]
            f32 = Precision("float32")
            with f32.active():
                goals = ref.sample_goals(gen, n, c)
                traj = ref.rollout(ref.per_task(self.params0, n), goals, gen,
                                   t["episodes"], t["horizon"], c, f32)
            self.pool = ref.Traj(*(x.reshape((t["pool"], t["batch"])
                                             + x.shape[1:]) for x in traj))
        self.server = PolicyServer(policy, self.params0, rl_cfg,
                                   algo=t["algo"], device=dev)
        self.calls = 0
        self.kept: list = []
        self.keep_from = self.seed % int(t["keep_every"])
        with self.phase("first_call"):     # builds or loads the kernels
            self.server.adapt_batched(self.support(0))
        with self.phase("capture_replay"):
            self.server.adapt_batched(self.support(0))

    def support(self, i: int) -> ref.Traj:
        return ref.Traj(*(x[i] for x in self.pool))

    def step(self) -> int:
        i = self.calls % self.traffic["pool"]
        t0 = time.perf_counter()
        out = self.server.adapt_batched(self.support(i))
        self.host_s.append(time.perf_counter() - t0)
        self.sync()
        if self.calls % self.traffic["keep_every"] == self.keep_from:
            self.kept.append((self.calls, i, policy_leaves(out)))
        self.calls += 1
        return self.traffic["batch"]

    def end_to_end(self, window: dict) -> dict:
        if not window["units"]:
            return {}
        from portbench.harness import p95
        lat = [s for s, n in window["latencies"] for _ in range(n)]
        return {"rl_serve_requests_per_s": window["units"]
                / window["seconds"],
                "rl_serve_p95_ms": 1e3 * p95(lat)}

    def unit_flops(self) -> float:
        t = self.traffic
        return roofline.vpg_request_flops(self.cfg, t["episodes"],
                                          t["horizon"])

    def dtype(self) -> str:
        return self.cfg["dtype"]

    def release(self) -> None:
        self.server = None

    def readings(self, variant: str) -> dict:
        """Adapted params of a sample of answered tasks (every slot of a
        call ``check_requests // batch`` times, each in a kept call drawn
        from the seed) against the reference's (float64):
        ``step_gap_all``, ``|got - want| / |want - meta|`` over the
        sample's steps together, and ``step_gap``, the largest of a single
        task's step."""
        if not self.kept:
            return {}
        t = self.traffic
        picks = slot_sample(self.seed, len(self.kept), t["batch"],
                            t["check_requests"] // t["batch"])
        support = ref.Traj(*(torch.stack([x[self.kept[k][1], r]
                                          for k, r in picks])
                             for x in self.pool))

        def adapt(prec):
            with prec.active():
                meta = ref.per_task(ref.cast(self.params0, prec), len(picks))
                sup = ref.Traj(*(x.to(prec.dtype) if x.is_floating_point()
                                 else x for x in support))
                return [t.double() for t in
                        ref.leaves(ref.vpg_adapt(meta, sup, self.cfg, prec))]

        want = adapt(Precision("float64"))
        other = in_place_of_program(variant, control_precision(self.cfg))
        if other is not None:
            got = adapt(other)
        else:
            got = [torch.stack([self.kept[k][2][j][r] for k, r in picks])
                   .double() for j in range(len(want))]
        meta = [t.double() for t in ref.leaves(self.params0)]

        def steps(params):
            return torch.cat([(p - m).reshape(len(picks), -1)
                              for p, m in zip(params, meta)], dim=1)

        d_got, d_want = steps(got), steps(want)
        err = d_got - d_want
        return {"step_gap_all": float(err.norm() / d_want.norm()),
                "step_gap": float((err.norm(dim=1)
                                   / d_want.norm(dim=1)).max())}
