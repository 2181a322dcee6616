"""Torch reproduction of the reference's few-shot vision training (the
port's copy of the torch side of ``scripts/parity_check.py``).

The plain reference of ``parity/check.py`` (vision mode): the reference's
training step exactly, with none of the port's adaptation code. Each task
of a meta-batch is adapted on its own, sequentially (the reference's
per-task clone): the inner SGD takes its gradients with
``create_graph=True``, the query loss of each task is backpropagated
divided by the meta-batch size, and Adam steps once a meta-batch; BN is
in train mode (batch statistics) throughout. The models are faithful
``torch.nn`` builds of the four reference vision configurations
(Omniglot- and Mini-ImageNet-shaped CNN4, MAML and ANIL). Tasks are drawn
on the host from a numpy generator with the episodic semantics of the
port's sampler (class-major, the even/odd support/query interleave).

It runs on the CPU by default, where the JAX package's harness ran it; on
the card TF32 is turned off for it (``models/layers.py:set_precision``),
so that its ``nn.Conv2d`` is held to float32 as the port's side is.
"""

from __future__ import annotations

import numpy as np
import torch

WAYS, SHOTS = 5, 1


def sample_np_task(rng, images, ways, shots, invert=True, rotations=True):
    """Host-side task sampler with the same episodic semantics (class-major,
    even/odd support/query interleave) for the torch side. ``invert`` and
    ``rotations`` are Omniglot-only transforms (reference
    ``utils/data_pre.py:17-35`` vs the plain Mini-ImageNet pipeline)."""
    n_cls, n_per = images.shape[0], images.shape[1]
    cls = rng.choice(n_cls, ways, replace=False)
    data, labels = [], []
    for c_new, c in enumerate(cls):
        smp = rng.choice(n_per, 2 * shots, replace=False)
        imgs = images[c, smp].astype(np.float32) / 255.0
        if invert:
            imgs = 1.0 - imgs
        if rotations:
            k = rng.integers(0, 4)
            imgs = np.rot90(imgs, k, axes=(1, 2)).copy()
        data.append(imgs)
        labels += [c_new] * 2 * shots
    data = np.concatenate(data)  # [ways*2s, H, W, C]
    labels = np.array(labels)
    idx_s = np.arange(shots * ways) * 2
    idx_q = idx_s + 1
    return (data[idx_s], labels[idx_s]), (data[idx_q], labels[idx_q])


def _torch_conv_base(in_ch, hidden, max_pool):
    """Reference ConvBase (vision_models.py:121-193): conv3x3 (stride 2
    when not max-pooling) -> BN(affine, U(0,1) weight) -> ReLU
    [-> maxpool2]; conv init xavier-uniform + zero bias."""
    blocks = []
    for _ in range(4):
        conv = torch.nn.Conv2d(in_ch, hidden, 3,
                               stride=1 if max_pool else 2, padding=1)
        torch.nn.init.xavier_uniform_(conv.weight)
        torch.nn.init.zeros_(conv.bias)
        bn = torch.nn.BatchNorm2d(hidden, affine=True)
        torch.nn.init.uniform_(bn.weight)
        blocks += [conv, bn, torch.nn.ReLU()]
        if max_pool:
            blocks.append(torch.nn.MaxPool2d(2, 2))
        in_ch = hidden
    return torch.nn.Sequential(*blocks)


class MamlOmni(torch.nn.Module):
    """64ch stride-2 ConvBase -> global spatial mean -> Linear(64, ways)
    with N(0,1) weight (vision_models.py:38-55)."""

    def __init__(self):
        super().__init__()
        self.base = _torch_conv_base(1, 64, max_pool=False)
        self.head = torch.nn.Linear(64, WAYS)
        with torch.no_grad():
            self.head.weight.normal_()
            self.head.bias.zero_()

    def forward(self, x):
        return self.head(self.base(x).mean(dim=[2, 3]))


class MamlMin(torch.nn.Module):
    """32ch maxpool ConvBase -> flatten 800 -> maml_init_ Linear
    (vision_models.py:93-110)."""

    def __init__(self):
        super().__init__()
        self.base = _torch_conv_base(3, 32, max_pool=True)
        self.head = torch.nn.Linear(800, WAYS)
        torch.nn.init.xavier_uniform_(self.head.weight)
        torch.nn.init.zeros_(self.head.bias)

    def forward(self, x):
        return self.head(self.base(x).flatten(1))


class Anil(torch.nn.Module):
    """ConvBase features + flatten + torch-default Linear head
    (anil_vision.py:85-94: omni hidden=32 stride-2 -> 128; min
    hidden=64 maxpool -> 1600; head built raw, keeping torch's
    default kaiming-uniform init)."""

    def __init__(self, channels, hidden, max_pool, fc):
        super().__init__()
        self.base = _torch_conv_base(channels, hidden, max_pool)
        self.head = torch.nn.Linear(fc, WAYS)

    def features(self, x):
        return self.base(x).flatten(1)

    def forward(self, x):
        return self.head(self.features(x))


class FeatWrap(torch.nn.Module):
    """Module view exposing only the feature path (base.*)."""

    def __init__(self, inner):
        super().__init__()
        self.base = inner.base

    def forward(self, x):
        return self.base(x).flatten(1)


def build_torch_model(dataset: str, anil: bool):
    """Faithful torch builds of the four reference vision configurations:
    OmniglotCNN (vision_models.py:10-63), MiniImagenetCNN (:66-118), and
    the two ANIL feature/head splits (vision/anil_vision.py:85-94), in
    train mode, on the CPU; ``model.head`` is ANIL's inner-loop target."""
    if anil:
        model = (Anil(1, 32, False, 128) if dataset == "omni"
                 else Anil(3, 64, True, 1600))
    else:
        model = MamlOmni() if dataset == "omni" else MamlMin()
    return model.train()


def run_torch(images_train, images_test, iters, meta_batch, inner_lr,
              outer_lr, adapt_steps, eval_tasks, seed, dataset="omni",
              anil=False, device="cpu"):
    """Train the reference for ``iters`` meta-batches of ``meta_batch``
    tasks from ``images_train`` (uint8 ``[n_cls, n_per, H, W, C]``), then
    -> its mean query accuracy over ``eval_tasks`` tasks from
    ``images_test``. The model is built on the CPU from ``seed`` and moved
    to ``device``, so its initial weights do not depend on the device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        from exploring_meta_tpu_torch.models.layers import set_precision
        set_precision("highest")
    torch.manual_seed(seed)
    rng = np.random.default_rng(seed)
    is_omni = dataset == "omni"

    model = build_torch_model(dataset, anil).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=outer_lr)
    loss_fn = torch.nn.CrossEntropyLoss()

    def to_t(x):
        return torch.tensor(x.transpose(0, 3, 1, 2), device=dev)

    def adapt_and_query_maml(params, support, query, track_higher):
        (xs, ys), (xq, yq) = support, query
        xs, xq = to_t(xs), to_t(xq)
        ys, yq = torch.tensor(ys, device=dev), torch.tensor(yq, device=dev)
        cur = params
        for _ in range(adapt_steps):
            loss = loss_fn(torch.func.functional_call(model, cur, (xs,)), ys)
            grads = torch.autograd.grad(loss, list(cur.values()),
                                        create_graph=track_higher)
            cur = {n: p - inner_lr * g
                   for (n, p), g in zip(cur.items(), grads)}
        logits = torch.func.functional_call(model, cur, (xq,))
        q_loss = loss_fn(logits, yq)
        acc = (logits.argmax(1) == yq).float().mean().item()
        return q_loss, acc

    def adapt_and_query_anil(params, support, query, track_higher):
        # prepare_batch(features=...) encodes the WHOLE 2NK batch in one
        # pass (shared BN statistics over support+query, data_pre.py:118),
        # then the inner loop adapts ONLY the head on those features
        # (anil_vision.py:93-99); the body graph is kept so meta-grads
        # reach it through both the head update and the query loss.
        (xs, ys), (xq, yq) = support, query
        n_s = xs.shape[0]
        x_all = to_t(np.concatenate([xs, xq]))
        ys, yq = torch.tensor(ys, device=dev), torch.tensor(yq, device=dev)
        base_params = {k: v for k, v in params.items()
                       if k.startswith("base.")}
        head_params = {k.split(".", 1)[1]: v for k, v in params.items()
                       if k.startswith("head.")}
        f_all = torch.func.functional_call(
            FeatWrap(model), base_params, (x_all,))
        f_s, f_q = f_all[:n_s], f_all[n_s:]
        cur = head_params
        for _ in range(adapt_steps):
            logits = torch.nn.functional.linear(f_s, cur["weight"],
                                                cur["bias"])
            loss = loss_fn(logits, ys)
            grads = torch.autograd.grad(loss, list(cur.values()),
                                        create_graph=track_higher)
            cur = {n: p - inner_lr * g
                   for (n, p), g in zip(cur.items(), grads)}
        logits = torch.nn.functional.linear(f_q, cur["weight"], cur["bias"])
        q_loss = loss_fn(logits, yq)
        acc = (logits.argmax(1) == yq).float().mean().item()
        return q_loss, acc

    adapt_and_query = adapt_and_query_anil if anil else adapt_and_query_maml

    def sample(images):
        return sample_np_task(rng, images, WAYS, SHOTS,
                              invert=is_omni, rotations=is_omni)

    for it in range(iters):
        opt.zero_grad()
        for _ in range(meta_batch):
            task = sample(images_train)
            params = dict(model.named_parameters())
            q_loss, _ = adapt_and_query(params, *task, track_higher=True)
            (q_loss / meta_batch).backward()
        opt.step()
        if (it + 1) % 25 == 0:
            print(f"torch iter {it + 1}/{iters}", flush=True)

    accs = []
    for _ in range(eval_tasks):
        task = sample(images_test)
        params = {n: p.detach().clone().requires_grad_(True)
                  for n, p in model.named_parameters()}
        _, acc = adapt_and_query(params, *task, track_higher=False)
        accs.append(acc)
    return float(np.mean(accs))
