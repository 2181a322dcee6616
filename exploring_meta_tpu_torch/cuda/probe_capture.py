"""Which building blocks of a meta-iteration a CUDA graph can capture, on
the card:

    python -m exploring_meta_tpu_torch.cuda.probe_capture

Each block runs once eagerly on a side stream, is then captured on that
stream and replayed, and one line says whether the capture held and how
far the replay lies from the eager result (max |difference|). First, a
generator registered with a graph (``register_generator_state``) is
checked to draw the eager stream in its replays and to continue it after
them. The last blocks are expected to fail: three move a Python number
to the card or read one back, which no capture can record, and one
solves through MAGMA, which syncs. A capture after them must still hold.
A failed capture leaves the default CUDA generator in capture mode until
the next capture, so every input is drawn before the first of them.
Exits 1 without a card.
"""

from __future__ import annotations

import sys

import torch

DEV = "cuda"


def capture(name: str, fn, gens=(), compare: bool = True) -> bool:
    """Eager run, capture and one replay of ``fn`` -> whether the capture
    held; prints one line."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            eager = fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        for gen in gens:
            graph.register_generator_state(gen)
        with torch.cuda.graph(graph, stream=side):
            out = fn()
        graph.replay()
        torch.cuda.synchronize()
        msg = ""
        if compare:
            pairs = zip(*(([t] if isinstance(t, torch.Tensor) else list(t))
                          for t in (out, eager)))
            msg = " max|replay - eager| " + str(max(
                float((a.float() - b.float()).abs().max()) for a, b in pairs))
        print(f"CAPTURE OK   {name}{msg}", flush=True)
        return True
    except Exception as exc:  # the failure is the finding; report it
        print(f"CAPTURE FAIL {name}: {type(exc).__name__}: "
              f"{str(exc).splitlines()[0][:200]}", flush=True)
        torch.cuda.synchronize()
        return False


def generator_stream() -> None:
    """Replays of a registered generator draw what eager draws would, and
    an eager draw after them continues the stream."""
    gen = torch.Generator(device=DEV).manual_seed(0)
    want = [torch.rand(7, generator=gen, device=DEV) for _ in range(5)]
    gen.manual_seed(0)
    got = [torch.rand(7, generator=gen, device=DEV)]    # eager warm-up
    buf = torch.zeros(7, device=DEV)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=side):
        buf.copy_(torch.rand(7, generator=gen, device=DEV))
    for _ in range(3):
        graph.replay()
        got.append(buf.clone())
    got.append(torch.rand(7, generator=gen, device=DEV))
    print("generator: replays and the draw after them equal the eager "
          f"stream: {[bool(torch.equal(a, b)) for a, b in zip(got, want)]}",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_capture: no CUDA device", file=sys.stderr)
        return 1
    from exploring_meta_tpu_torch.cuda import cnn4_cuda as tc
    from exploring_meta_tpu_torch.cuda import gae_cuda as gc
    print(f"torch {torch.__version__}, {torch.cuda.get_device_name(0)}",
          flush=True)
    generator_stream()

    a = torch.randn(20, 40, 8, device=DEV)
    m = a.transpose(-1, -2) @ a + 1e-5 * torch.eye(8, device=DEV)
    r = torch.randn(20, 8, 1, device=DEV)
    capture("batched solve_ex [20, 8, 8] (the baseline fit)",
            lambda: torch.linalg.solve_ex(m, r)[0])

    gen = torch.Generator(device=DEV).manual_seed(1)
    images = torch.randint(0, 255, (100, 20, 28, 28, 1), dtype=torch.uint8,
                           device=DEV)

    def sample():
        cls = torch.rand((32, 100), generator=gen,
                         device=DEV).argsort(-1)[:, :5]
        smp = torch.rand((32, 5, 20), generator=gen,
                         device=DEV).argsort(-1)[..., :10]
        data = images[cls[..., None], smp].float() / 255.0
        k = torch.randint(0, 4, (32, 5), generator=gen,
                          device=DEV)[:, :, None, None, None, None]
        out = data
        for rot in (1, 2, 3):
            out = torch.where(k == rot, torch.rot90(data, rot, dims=(3, 4)),
                              out)
        return out

    capture("the sampler's draws, argsort, gather and rot90", sample,
            gens=(gen,), compare=False)
    capture("labels by floor division",
            lambda: torch.arange(50, device=DEV) // 10)
    capture("repeat_interleave by an int",
            lambda: torch.arange(5, device=DEV).repeat_interleave(10))
    v = torch.randn(10, device=DEV)
    capture("new_full", lambda: torch.maximum(v, v.new_full((), 0.7)))

    w1 = torch.randn(2, 32, device=DEV, requires_grad=True)
    w2 = torch.randn(32, 2, device=DEV, requires_grad=True)
    opt = torch.optim.Adam([w1, w2], lr=1e-2, capturable=True)
    inp = torch.randn(20, 50, 2, device=DEV)

    def adam_step():
        per_task = w1.unsqueeze(0).expand(20, 2, 32)

        def loss_fn(p):
            return (torch.maximum(inp @ p, torch.zeros((), device=DEV))
                    @ w2).pow(2).mean()

        (g,) = torch.autograd.grad(loss_fn(per_task) * 20, per_task,
                                   create_graph=True)
        loss = loss_fn(per_task - 0.05 * g)
        for p, gg in zip((w1, w2), torch.autograd.grad(loss, (w1, w2))):
            if p.grad is None:
                p.grad = gg
            else:
                p.grad.copy_(gg)
        opt.step()
        return loss.detach()

    capture("second order through an MLP, capturable Adam", adam_step,
            compare=False)

    rew = torch.randn(20, 100, 20, device=DEV)
    done = (torch.rand(20, 100, 20, device=DEV) < 0.05).float()
    val = torch.randn(20, 100, 20, device=DEV)
    capture("gae_sweep and discount_sweep",
            lambda: (gc.gae_sweep(0.99, 1.0, rew, done, val),
                     gc.discount_sweep(0.99, rew, done)))

    def block(h, ci, scale):
        x = torch.randn(4, 10, h, h, ci, device=DEV, requires_grad=True)
        w = (scale * torch.randn(4, 3, 3, ci, 64, device=DEV)
             ).requires_grad_()
        ps = [torch.zeros(4, 64, device=DEV, requires_grad=True),
              torch.ones(4, 64, device=DEV, requires_grad=True),
              torch.zeros(4, 64, device=DEV, requires_grad=True)]
        return x, w, ps

    x, w, ps = block(28, 1, 0.3)

    def block1():
        (gw,) = torch.autograd.grad(
            tc.FusedBlock.apply(x, w, *ps).pow(2).sum(), w,
            create_graph=True)
        y = tc.FusedBlock.apply(x, w - 0.1 * gw, *ps)
        return torch.autograd.grad(y.sum(), [w, ps[1]])

    capture("CNN4 block 1: kernels under FusedBlockBackward's double "
            "backward", block1)
    x2, w2_, ps2 = block(14, 64, 0.1)

    def block2():
        gx, gw = torch.autograd.grad(
            tc.FusedBlock.apply(x2, w2_, *ps2).pow(2).sum(), [x2, w2_],
            create_graph=True)
        return torch.autograd.grad(gx.pow(2).sum() + gw.sum(),
                                   [x2, w2_, ps2[1]])

    capture("CNN4 block 2 with dx, double backward", block2)

    capture("cholesky_ex + cholesky_solve (expected to fail)",
            lambda: torch.cholesky_solve(r, torch.linalg.cholesky_ex(m)[0]))
    capture("new_tensor (expected to fail)",
            lambda: torch.maximum(v, v.new_tensor(0.7)))
    capture("as_tensor of a Python bool (expected to fail)",
            lambda: torch.where(torch.as_tensor(True, device=DEV), v, 2 * v))
    capture(".item() (expected to fail)", lambda: v * v.sum().item())
    capture("gae_sweep after the failures",
            lambda: gc.gae_sweep(0.99, 1.0, rew, done, val))
    return 0


if __name__ == "__main__":
    sys.exit(main())
