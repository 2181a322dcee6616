"""Few-shot serving of a meta-trained CNN4 (port of ``VisionServer`` from
``exploring_meta_tpu/serve.py``).

One request is ``(support_x [S, H, W, C], support_y [S], query_x [Q, H, W,
C])``. The server adapts the model on the support set with the inner SGD
it was meta-trained with (first order: serving takes no meta-gradient),
then predicts the queries. :meth:`VisionServer.batch` serves B requests
at once, with the request axis written out: each request's params are
adapted on its own support set, and BN statistics are per request. On
the Omniglot spec the base runs on the fused CUDA block kernels
(``set_conv_impl("fused")``, the default).

Eager PyTorch compiles nothing per batch size, so ``batch`` serves exactly
B requests; the JAX server's power-of-two buckets, which bound XLA
compiles, have no counterpart here.
"""

from __future__ import annotations

import torch

from exploring_meta_tpu_torch.adapt.maml import inner_sgd, per_task
from exploring_meta_tpu_torch.device import resolve_device
from exploring_meta_tpu_torch.models.cnn4 import (
    CNN4Spec, cnn4_apply, cnn4_features, cnn4_head_apply, init_cnn4,
)
from exploring_meta_tpu_torch.ops.losses import cross_entropy
from exploring_meta_tpu_torch.utils.tree import tree_map


class VisionServer:
    """Few-shot classification serving on a meta-trained CNN4.

    ``compute_dtype=torch.bfloat16`` runs adaptation and prediction in
    bf16; probabilities come back in f32 either way. ``device`` defaults
    to the card; pass ``device="cpu"`` to serve on the CPU."""

    def __init__(self, spec: CNN4Spec, params, *, inner_lr: float,
                 adapt_steps: int, anil: bool = False, compute_dtype=None,
                 device=None):
        self.spec = spec
        self.device = resolve_device(device)
        self.inner_lr = inner_lr
        self.adapt_steps = adapt_steps
        self.anil = anil
        self.compute_dtype = compute_dtype
        self.params = tree_map(lambda t: t.detach().to(self.device), params)

    @classmethod
    def from_checkpoint(cls, path: str, spec: CNN4Spec, **kwargs):
        """Load a ``model.npz`` written by the JAX trainers or by
        :func:`~exploring_meta_tpu_torch.utils.experiment.flatten_params`."""
        from exploring_meta_tpu_torch.utils.experiment import load_params
        template = init_cnn4(torch.Generator().manual_seed(0), spec,
                             device="cpu")
        return cls(spec, load_params(path, template), **kwargs)

    def _as_input(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device, dtype=dtype)

    def __call__(self, support_x, support_y, query_x):
        """Serve one request -> ``(predicted_labels [Q], probs [Q, ways])``."""
        preds, probs = self.batch(*(self._as_input(a).unsqueeze(0)
                                    for a in (support_x, support_y, query_x)))
        return preds[0], probs[0]

    def batch(self, support_x, support_y, query_x):
        """Serve B requests (leading axis) -> ``(preds [B, Q],
        probs [B, Q, ways])``."""
        sx = self._as_input(support_x, torch.float32)
        qx = self._as_input(query_x, torch.float32)
        sy = self._as_input(support_y).long()
        p = self.params
        if self.compute_dtype is not None:
            p = tree_map(lambda t: t.to(self.compute_dtype), p)
            sx, qx = sx.to(self.compute_dtype), qx.to(self.compute_dtype)
        B = sx.shape[0]
        spec = self.spec
        if self.anil:
            # The body encodes support+query jointly (batch-stat BN as in
            # meta-training), then only the head adapts.
            with torch.no_grad():
                feats = cnn4_features(p, spec, torch.cat([sx, qx], dim=1))
            f_s, f_q = feats[:, : sx.shape[1]], feats[:, sx.shape[1]:]

            def head_loss(head, batch):
                f, y = batch
                return cross_entropy(cnn4_head_apply({"head": head}, f),
                                     y).sum()

            head = inner_sgd(head_loss, per_task(p["head"], B), (f_s, sy),
                             self.inner_lr, self.adapt_steps, first_order=True)
            with torch.no_grad():
                logits = cnn4_head_apply({"head": head}, f_q)
        else:
            def loss(pp, batch):
                x, y = batch
                return cross_entropy(cnn4_apply(pp, spec, x), y).sum()

            adapted = inner_sgd(loss, per_task(p, B), (sx, sy),
                                self.inner_lr, self.adapt_steps,
                                first_order=True)
            with torch.no_grad():
                logits = cnn4_apply(adapted, spec, qx)
        probs = torch.softmax(logits.float(), dim=-1)
        return probs.argmax(dim=-1), probs
