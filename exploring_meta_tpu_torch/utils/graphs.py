"""Fused meta-iterations as CUDA-graph replays (the port's counterpart of
running ``n`` iterations under ``lax.scan`` as one XLA program, ``--fuse
N``).

A training iteration that reads and writes only tensors that outlive it
(params and optimizer state stepped in place) and draws its randomness from
one ``torch.Generator`` is captured once as a ``torch.cuda.CUDAGraph`` and
each later iteration is one replay: the host issues one graph launch an
iteration instead of thousands of kernel launches.

:class:`FusedIterations` runs chunks of such iterations. Each iteration
writes its metrics into row ``row`` of a ``[n_steps, metrics]`` device
buffer and advances ``row`` on the device, so a replay needs nothing from
the host. On the card the first iteration of the first chunk runs eagerly
on the capture stream (the warm-up: a real iteration, logged like the
others), the iteration is then captured, which runs nothing and draws
nothing, and every later iteration of any chunk length is a replay of that
one graph. The run's generator is registered with the graph
(``CUDAGraph.register_generator_state``), so each replay draws the numbers
that the eager iteration at that point of the stream would draw. On the
CPU the same loop runs the iteration eagerly.

A capture that fails (a host sync inside the iteration, say) raises; there
is no eager fallback on the card.
"""

from __future__ import annotations

from typing import Callable

import torch

# captures and replays since the last reset_counts(), over every loop
COUNTS = {"captures": 0, "replays": 0}


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


def count_launch(wrapper) -> None:
    """A kernel wrapper's counter: ``wrapper.launches`` counts launches;
    a call made while the current stream is being captured launches
    nothing (its kernel runs in each replay), so it counts in
    ``wrapper.captured`` instead."""
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1


class FusedIterations:
    """``loop(n) -> {metric: [n] tensor}``: ``n <= n_steps`` iterations of
    ``iteration() -> {metric: 0-dim tensor}``, which must update its state
    in place and draw only from ``generators``. With ``metric_shape``
    (``(S,)`` for a one-program seed sweep) every metric of an iteration
    has that shape, and the loop returns ``[n, *metric_shape]``."""

    def __init__(self, iteration: Callable[[], dict], n_steps: int, device,
                 generators=(), metric_shape: tuple = ()):
        self.iteration = iteration
        self.n_steps = n_steps
        self.device = torch.device(device)
        self.generators = tuple(generators)
        self.metric_shape = tuple(metric_shape)
        self.keys: tuple = ()
        self.buffer = None
        self.row = torch.zeros((), dtype=torch.long, device=self.device)
        self.stream = None
        self.graph = None

    def step(self) -> None:
        """One iteration, its metrics written into the buffer's next row."""
        metrics = self.iteration()
        if self.buffer is None:
            self.keys = tuple(metrics)
            self.buffer = torch.zeros(
                (self.n_steps, len(self.keys)) + self.metric_shape,
                device=self.device)
        row = torch.stack([metrics[k].detach().to(torch.float32)
                           .reshape(self.metric_shape) for k in self.keys])
        self.buffer.index_copy_(0, self.row.view(1), row.unsqueeze(0))
        self.row.add_(1)

    def _warm_up(self) -> None:
        self.stream = torch.cuda.Stream(self.device)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            self.step()
        torch.cuda.current_stream(self.device).wait_stream(self.stream)

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        with torch.cuda.graph(graph, stream=self.stream):
            self.step()
        self.graph = graph
        COUNTS["captures"] += 1

    def __call__(self, n: int | None = None) -> dict:
        n = self.n_steps if n is None else n
        if not 1 <= n <= self.n_steps:
            raise ValueError(f"a chunk of {n} iterations; this loop runs 1 "
                             f"to {self.n_steps}")
        self.row.zero_()
        for _ in range(n):
            if self.device.type != "cuda":
                self.step()
            elif self.buffer is None:
                self._warm_up()
            else:
                if self.graph is None:
                    self._capture()
                self.graph.replay()
                COUNTS["replays"] += 1
        rows = self.buffer[:n].clone()
        return {k: rows[:, i] for i, k in enumerate(self.keys)}


def bind_once(make: Callable):
    """-> ``get(*objs)``: ``make(*objs)`` on the first call, the same
    result after it; a later call with other objects (by identity) raises,
    since a captured iteration reads and writes the tensors it was built
    on. ``get.bound()`` is that result, or None before the first call."""
    cache: list = []

    def get(*objs):
        ids = tuple(map(id, objs))
        if not cache:
            cache.append((ids, objs, make(*objs)))
        elif cache[0][0] != ids:
            raise ValueError("this fused train function is bound to the "
                             "params, optimizer and generator of its first "
                             "call")
        return cache[0][2]

    get.bound = lambda: cache[0][2] if cache else None
    return get
