"""The port's vision parity run against the torch reproduction of the
reference on ONE initialisation and ONE task stream
(``parity/check.py:run_port`` beside ``parity/reference_vision.py:
run_torch``).

``parity_check`` trains the two sides on independent streams: each draws
its initial weights and its tasks from its own generator, so a gap
between them mixes what the two implementations compute with which tasks
each drew. Here the reproduction runs as it is, its initial weights and
every task it samples are recorded, and the port's run is handed the
same weights and the same tasks in the same order (the training batches,
then the eval batches): the two runs differ only in their code.

On the CPU, at full width, 2 meta-steps of 2 tasks and 4 eval tasks for
MAML / ANIL on both dataset shapes: the same eval accuracy and the same
trained weights, as far as the test below sets out.
On the card (marker ``cuda``; ``python -m pytest --noconftest -q -s
tests/test_torch_parity_matched.py -m cuda``): the budgets of the parity
matrix where the two sides part, each printed as one JSON line: Omniglot-
shaped MAML at 25 x 8 (1024 eval tasks) and ANIL Mini-ImageNet-shaped at
100 x 8 (256 eval tasks), seeds 42, 7, 123, both sides on the card with
TF32 off.
"""

import json
import time

import numpy as np
import pytest
import torch

from exploring_meta_tpu_torch.parity import check, reference_vision
from exploring_meta_tpu_torch.utils.import_torch import _conv_w, _flat_head_w
from exploring_meta_tpu_torch.utils.tree import tree_items

WAYS = check.WAYS


def port_params(model, spec, device) -> dict:
    """The reproduction's ``model`` (a ConvBase Sequential and a Linear
    head) -> the port's CNN4 params, NHWC, on ``device``."""
    convs = [m for m in model.base if isinstance(m, torch.nn.Conv2d)]
    bns = [m for m in model.base if isinstance(m, torch.nn.BatchNorm2d)]
    base = [{"conv": {"w": _conv_w(c.weight.detach()),
                      "b": c.bias.detach().clone()},
             "bn": {"scale": b.weight.detach().clone(),
                    "bias": b.bias.detach().clone()}}
            for c, b in zip(convs, bns)]
    w = model.head.weight.detach()
    if spec.global_pool:
        head_w = w.t().contiguous()
    else:
        spatial = int(round((spec.head_in / spec.hidden) ** 0.5))
        head_w = _flat_head_w(w, spec.hidden, spatial)
    params = {"base": base, "head": {"w": head_w,
                                     "b": model.head.bias.detach().clone()}}
    return {"base": [{k: {n: t.to(device) for n, t in v.items()}
                      for k, v in blk.items()} for blk in params["base"]],
            "head": {n: t.to(device) for n, t in params["head"].items()}}


def matched_run(monkeypatch, dataset, anil, iters, meta_batch, inner_lr,
                eval_tasks, seed, device) -> dict:
    """The reproduction's run, then the port's on its initial weights and
    its tasks -> both accuracies, both trained weights (port layout) and
    both sides' seconds."""
    dev = torch.device(device)
    train, test = check.load_vision_data(dataset, dev)
    spec = check.vision_spec(dataset, anil)
    tasks, built = [], {}
    sample, build = reference_vision.sample_np_task, \
        reference_vision.build_torch_model

    def recording_sample(*a, **k):
        tasks.append(sample(*a, **k))
        return tasks[-1]

    def recording_build(*a, **k):
        model = build(*a, **k)
        built["init"] = port_params(model, spec, dev)
        built["model"] = model
        return model

    monkeypatch.setattr(reference_vision, "sample_np_task", recording_sample)
    monkeypatch.setattr(reference_vision, "build_torch_model",
                        recording_build)
    t0 = time.perf_counter()
    ref_acc = reference_vision.run_torch(
        train.images.cpu().numpy(), test.images.cpu().numpy(), iters,
        meta_batch, inner_lr, 0.003, 1, eval_tasks, seed, dataset=dataset,
        anil=anil, device=dev)
    t1 = time.perf_counter()
    assert len(tasks) == iters * meta_batch + eval_tasks
    stream = iter(tasks)

    def replayed_batch(gen, ds, ways, shots, n):
        data, labels = [], []
        for (xs, ys), (xq, yq) in (next(stream) for _ in range(n)):
            x = np.empty((2 * len(xs),) + xs.shape[1:], np.float32)
            y = np.empty(2 * len(ys), np.int64)
            x[0::2], x[1::2], y[0::2], y[1::2] = xs, xq, ys, yq
            data.append(x)
            labels.append(y)
        return (torch.from_numpy(np.stack(data)).to(dev),
                torch.from_numpy(np.stack(labels)).to(dev))

    trained = {}
    make_eval = check.make_meta_eval

    def recording_eval(fa):
        ev = make_eval(fa)

        def run(params, *a):
            trained["port"] = params
            return ev(params, *a)
        return run

    monkeypatch.setattr(check.cnn4, "init_cnn4",
                        lambda gen, spec, device: built["init"])
    monkeypatch.setattr(check, "sample_task_batch", replayed_batch)
    monkeypatch.setattr(check, "make_meta_eval", recording_eval)
    port_acc, _ = check.run_port(train, test, iters, meta_batch, inner_lr,
                                 0.003, 1, eval_tasks, seed, dataset=dataset,
                                 anil=anil, device=dev)
    t2 = time.perf_counter()
    monkeypatch.undo()
    return {"port_acc": port_acc, "torch_acc": ref_acc,
            "port": {k: v.detach().cpu().double().numpy()
                     for k, v in tree_items(trained["port"])},
            "torch": {k: v.cpu().double().numpy() for k, v in tree_items(
                port_params(built["model"], spec, "cpu"))},
            "seconds": {"port": t2 - t1, "reference": t1 - t0}}


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("dataset,anil", [("omni", False), ("omni", True),
                                          ("min", False), ("min", True)],
                         ids=["omni-maml", "omni-anil", "min-maml",
                              "min-anil"])
def test_port_trains_as_the_reference_on_one_stream(dataset, anil,
                                                    monkeypatch, one_thread):
    """Two meta-steps from the reproduction's weights on its tasks, then
    4 eval tasks: the same eval accuracy, and the port's trained weights
    where the reproduction's are, conv biases aside (BN removes them, so
    their gradient is rounding and Adam steps them either way).

    Omniglot-shaped (no max-pool): element for element within 0.1 lr but
    for at most 2e-3 of the elements (measured: none for MAML, 1.5e-3 for
    ANIL, weights whose gradient is at rounding level, where Adam's first
    update, ~lr * sign(g), takes either sign). Mini-ImageNet-shaped: the
    median element within 0.1 lr (measured 0.065 lr for MAML, 0.0085 lr
    for ANIL; 38 % and 4.3 % of the elements lie further). There a
    ReLU input at the kink or two near-equal values in a max-pool window,
    which the synthetic images' flat regions make common, fall one way in
    one float32 implementation and the other way in the other; each such
    decision moves a whole gradient entry, so the two meta-gradients part
    by more than rounding from the first step on."""
    lr = 0.003
    res = matched_run(monkeypatch, dataset, anil, 2, 2,
                      0.5 if dataset == "omni" else 0.1, 4, 42, "cpu")
    assert res["port"].keys() == res["torch"].keys()
    drift = np.concatenate([np.abs(p - res["torch"][k]).ravel() / lr
                            for k, p in res["port"].items()
                            if not k.endswith("conv/b")])
    if dataset == "omni":
        assert (drift > 0.1).mean() <= 2e-3, (drift > 0.1).mean()
    else:
        assert np.median(drift) <= 0.1, np.median(drift)
    assert res["port_acc"] == pytest.approx(res["torch_acc"], abs=1e-6)


CARD_ROWS = [("omni", False, 25, 8, 0.5, 1024),
             ("min", True, 100, 8, 0.1, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [42, 7, 123])
@pytest.mark.parametrize("row", CARD_ROWS, ids=["omni-maml-25x8",
                                                "min-anil-100x8"])
def test_matched_parity_on_the_card(row, seed, monkeypatch):
    """Prints the matched gap of one row and seed, and how far the port's
    trained weights lie from the reproduction's (median element, in
    units of the outer lr); holds that both runs learned (above
    chance)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from exploring_meta_tpu_torch.models.layers import set_precision
    set_precision("highest")
    dataset, anil, iters, mb, inner_lr, eval_tasks = row
    res = matched_run(monkeypatch, dataset, anil, iters, mb, inner_lr,
                      eval_tasks, seed, "cuda")
    drift = np.median(np.concatenate(
        [np.abs(p - res["torch"][k]).ravel()
         for k, p in res["port"].items() if not k.endswith("conv/b")]))
    print(json.dumps({
        "matched": True, "dataset": dataset, "anil": anil, "iters": iters,
        "meta_batch": mb, "eval_tasks": eval_tasks, "seed": seed,
        "port_acc": round(res["port_acc"], 4),
        "torch_acc": round(res["torch_acc"], 4),
        "gap": round(res["port_acc"] - res["torch_acc"], 4),
        "median_weight_drift_lr": float(drift / 0.003),
        "seconds": res["seconds"],
        "device": torch.cuda.get_device_name(0)}), flush=True)
    assert min(res["port_acc"], res["torch_acc"]) > 1.0 / WAYS
