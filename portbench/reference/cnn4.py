"""Plain PyTorch CNN4 few-shot learning: the forward, MAML's inner SGD
step, the second-order meta-gradient and Adam.

Finn et al. 2017 (arXiv:1703.03400) §5.1 on Omniglot, as the reference
repository's ``vision/maml_vision.py`` runs it: four blocks of a 3x3
stride-2 convolution (padding 1), batch-statistics BatchNorm (biased
variance, eps 1e-5, no running statistics) and ReLU, the spatial mean,
and a linear head. Weights come in the layout the benchmark makes them
in (``synth.cnn4_params``: HWIO convolutions, ``[in, out]`` head); images
are ``[N, H, W, C]``. One task at a time: BN statistics are a task's own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.precision import Precision

BN_EPS = 1e-5


def leaves(params: dict) -> list:
    """``(path, tensor)`` in a fixed order."""
    out = []
    for k, block in enumerate(params["base"]):
        for group in ("conv", "bn"):
            for key in sorted(block[group]):
                out.append((f"base/{k}/{group}/{key}", block[group][key]))
    for key in sorted(params["head"]):
        out.append((f"head/{key}", params["head"][key]))
    return out


def rebuild(like: dict, tensors: list) -> dict:
    """``like``'s structure with ``tensors`` in :func:`leaves` order."""
    it = iter(tensors)
    base = [{g: {k: next(it) for k in sorted(b[g])} for g in ("conv", "bn")}
            for b in like["base"]]
    head = {k: next(it) for k in sorted(like["head"])}
    return {"base": base, "head": head}


def cast(params: dict, prec: Precision) -> dict:
    return rebuild(params, [t.detach().to(prec.dtype)
                            for _, t in leaves(params)])


def forward(params: dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Logits ``[N, ways]`` of one task's images ``[N, H, W, C]``."""
    h = x.permute(0, 3, 1, 2)
    for block in params["base"]:
        w = block["conv"]["w"].permute(3, 2, 0, 1)           # OIHW
        h = F.conv2d(h, w, block["conv"]["b"], stride=2, padding=1)
        mean = h.mean(dim=(0, 2, 3), keepdim=True)
        var = (h - mean).square().mean(dim=(0, 2, 3), keepdim=True)
        h = (h - mean) * torch.rsqrt(var + BN_EPS)
        h = (h * block["bn"]["scale"].view(1, -1, 1, 1)
             + block["bn"]["bias"].view(1, -1, 1, 1))
        h = torch.relu(h)
    feats = h.mean(dim=(2, 3))
    return feats @ params["head"]["w"] + params["head"]["b"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits, labels)


def adapt(params: dict, sx, sy, lr: float, steps: int, prec: Precision,
          create_graph: bool) -> dict:
    """``steps`` steps of SGD on the support loss of one task."""
    for _ in range(steps):
        flat = [t for _, t in leaves(params)]
        if not create_graph:
            flat = [t.detach().requires_grad_() for t in flat]
            params = rebuild(params, flat)
        loss = cross_entropy(forward(params, sx, prec), sy)
        grads = torch.autograd.grad(loss, flat, create_graph=create_graph)
        params = rebuild(params, [p - lr * g for p, g in zip(flat, grads)])
    return params


def serve(params: dict, sx, sy, qx, cfg: dict, prec: Precision):
    """One served request (first-order adaptation, then the queries) ->
    probabilities ``[Q, ways]`` in float64."""
    with prec.active():
        p = cast(params, prec)
        with torch.enable_grad():
            adapted = adapt(p, sx.to(prec.dtype), sy, cfg["inner_lr"],
                            cfg["adapt_steps"], prec, create_graph=False)
        with torch.no_grad():
            logits = forward(adapted, qx.to(prec.dtype), prec)
        return torch.softmax(logits, dim=-1).double()


def meta_loss(params: dict, batch, cfg: dict, prec: Precision):
    """The mean over tasks of the query loss after the inner step, kept to
    second order. ``batch``: ``(sx [B, S, ...], sy [B, S], qx, qy)``."""
    sx, sy, qx, qy = batch
    total = 0.0
    for b in range(sx.shape[0]):
        adapted = adapt(params, sx[b], sy[b], cfg["inner_lr"],
                        cfg["adapt_steps"], prec, create_graph=True)
        total = total + cross_entropy(forward(adapted, qx[b], prec), qy[b])
    return total / sx.shape[0]


def meta_train(params: dict, batches: list, cfg: dict, prec: Precision):
    """Second-order MAML with Adam (b1 0.9, b2 0.999, eps 1e-8 outside the
    root, lr ``outer_lr``) over ``batches`` -> ``(losses, first gradients,
    params after each step)``, the last two as :func:`leaves` lists."""
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, cfg["outer_lr"]
    with prec.active():
        p = [t for _, t in leaves(cast(params, prec))]
        m = [torch.zeros_like(t) for t in p]
        v = [torch.zeros_like(t) for t in p]
        losses, first, after = [], None, []
        for step, batch in enumerate(batches, start=1):
            x = [t.detach().requires_grad_() for t in p]
            batch = tuple(t.to(prec.dtype) if t.is_floating_point() else t
                          for t in batch)
            with torch.enable_grad():
                loss = meta_loss(rebuild(params, x), batch, cfg, prec)
                grads = torch.autograd.grad(loss, x)
            losses.append(float(loss.detach()))
            if first is None:
                first = [g.detach() for g in grads]
            with torch.no_grad():
                for i, g in enumerate(grads):
                    m[i] = b1 * m[i] + (1 - b1) * g
                    v[i] = b2 * v[i] + (1 - b2) * g * g
                    mh = m[i] / (1 - b1 ** step)
                    vh = v[i] / (1 - b2 ** step)
                    p[i] = p[i] - lr * mh / (vh.sqrt() + eps)
            after.append([t.detach() for t in p])
        return losses, first, after
