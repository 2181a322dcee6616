"""Few-shot serving: a closed loop of one caller, each call a batch of
requests through ``VisionServer.batch`` (``serve.py``), on fresh inputs
from a pool made on the device from the seed. A call ends when its
predictions are on the host.

Traffic keys: ``batch`` (requests a call), ``pool`` (distinct batches,
used in turn), ``keep_every`` (every so many calls' answers are kept for
the check), ``check_requests`` (answered requests the check samples, a
whole number of times ``batch``),
``profile_steps`` (calls in the traced stretch).
"""

from __future__ import annotations

import time

import torch

from portbench import roofline, synth
from portbench.drivers.common import (
    Driver as Base, in_place_of_program, port_precision, slot_sample,
)
from portbench.reference import cnn4 as ref
from portbench.reference.precision import Precision, control_precision


class Driver(Base):
    unit = "requests"

    def setup(self) -> None:
        with self.phase("import_port"):
            from exploring_meta_tpu_torch.models.cnn4 import CNN4Spec
            from exploring_meta_tpu_torch.serve import VisionServer
        port_precision()
        c, t, dev = self.cfg, self.traffic, self.device
        with self.phase("data"):
            self._data()
        spec = CNN4Spec(channels=c["channels"], hidden=c["hidden"],
                        layers=c["layers"], max_pool=False,
                        head_in=c["hidden"], ways=c["ways"],
                        image_size=c["image_size"], head_init="normal",
                        global_pool=True)
        dtype = getattr(torch, c["compute_dtype"])
        self.server = VisionServer(
            spec, self.params, inner_lr=c["inner_lr"],
            adapt_steps=c["adapt_steps"],
            compute_dtype=None if dtype == torch.float32 else dtype,
            device=dev)
        self.calls = 0
        self.kept: list = []        # (call, pool index, probs on device)
        self.keep_from = self.seed % int(t["keep_every"])
        with self.phase("first_call"):     # builds or loads the kernels
            self.server.batch(self.sx[0], self.sy, self.qx[0])
        with self.phase("capture_replay"):
            self.server.batch(self.sx[0], self.sy, self.qx[0])

    def _data(self) -> None:
        """Weights and the request pool from the seed."""
        c, t, dev = self.cfg, self.traffic, self.device
        self.params = synth.cnn4_params(
            synth.generator(self.seed, synth.WEIGHTS, dev), c)
        images = synth.omniglot_images(
            synth.generator(self.seed, synth.DATA, dev), c["classes"],
            c["per_class"], c["image_size"])
        ways, shots, q = c["ways"], c["shots"], c["queries"]
        per_class_q = q // ways
        cls, smp = synth.task_tables(
            synth.generator(self.seed, synth.TASKS, dev), t["pool"],
            t["batch"], ways, c["classes"], c["per_class"],
            shots + per_class_q)
        data = synth.gather_tasks(images, cls, smp)  # [P, B, W, S+Q, ...]
        hw = data.shape[-3:]
        self.sx = data[:, :, :, :shots].reshape(
            (t["pool"], t["batch"], ways * shots) + hw).contiguous()
        self.qx = data[:, :, :, shots:].reshape(
            (t["pool"], t["batch"], ways * per_class_q) + hw).contiguous()
        self.sy = (torch.arange(ways * shots, device=dev) // shots).expand(
            t["batch"], -1).contiguous()
        del images, data

    def step(self) -> int:
        i = self.calls % self.traffic["pool"]
        t0 = time.perf_counter()
        preds, probs = self.server.batch(self.sx[i], self.sy, self.qx[i])
        self.host_s.append(time.perf_counter() - t0)
        preds.cpu()                  # the answers on the host: the sync
        if self.calls % self.traffic["keep_every"] == self.keep_from:
            self.kept.append((self.calls, i, probs))
        self.calls += 1
        return preds.shape[0]

    def end_to_end(self, window: dict) -> dict:
        if not window["units"]:
            return {}
        from portbench.harness import p95
        lat = [s for s, n in window["latencies"] for _ in range(n)]
        return {"serve_requests_per_s": window["units"] / window["seconds"],
                "serve_p95_ms": 1e3 * p95(lat)}

    # the yardstick of this cell's per-layer metrics
    def unit_flops(self) -> float:
        return roofline.serve_request_flops(self.cfg)

    def dtype(self) -> str:
        return self.cfg["compute_dtype"]

    def kernel_bound_s(self) -> float:
        return self.traffic["batch"] * roofline.serve_request_kernel_bound(
            self.cfg, self.cfg["compute_dtype"])

    def release(self) -> None:
        self.server = None

    def readings(self, variant: str) -> dict:
        """Served probabilities of a sample of answered requests (every
        slot of a call, each in kept calls drawn from the seed) against the
        reference's (float64), as centred log-probabilities of a query:
        ``logit_gap`` the norm of their difference over the reference's
        norm, over the whole sample (one wrong request in it shows), and
        ``logit_med`` the same of the median query."""
        if not self.kept:
            return {}
        t = self.traffic
        picks = slot_sample(self.seed, len(self.kept), t["batch"],
                            t["check_requests"] // t["batch"])
        exact = Precision("float64")
        other = in_place_of_program(variant, control_precision(self.cfg))
        got_all, want_all = [], []
        for k, r in picks:
            _, i, probs = self.kept[k]
            args = (self.sx[i, r], self.sy[r], self.qx[i, r])
            want_all.append(ref.serve(self.params, *args, self.cfg, exact))
            got_all.append(probs[r].double() if other is None
                           else ref.serve(self.params, *args, self.cfg,
                                          other))
        got, want = torch.stack(got_all), torch.stack(want_all)

        def centred(p):
            z = torch.log(p.clamp(min=1e-30))
            return z - z.mean(dim=-1, keepdim=True)

        dz, cw = centred(got) - centred(want), centred(want)
        per_query = dz.norm(dim=-1) / cw.norm(dim=-1)
        return {"logit_gap": float(dz.norm() / cw.norm()),
                "logit_med": float(per_query.median())}
