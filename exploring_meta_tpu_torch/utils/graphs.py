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

:class:`CapturedCalls` is the servers' counterpart of a jitted function,
which XLA compiles once per input shape: one graph per key (a name, the
device, each input's shape and dtype), captured at the key's first call
and replayed at every later one.

Inside ``utils/profiling.py:tracing`` both keep a second graph, an
instrumented twin captured at the first traced call (or chunk) with a
device mark first and last (the ``graphs.replay`` span's site), so each
replay's device time is stamped; graphs captured outside it hold no mark.
Their host path is spanned: ``graphs.copy_in``, ``graphs.replay``,
``graphs.clone_out``, ``graphs.capture`` and a fused ``graphs.chunk``.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable

import torch

from exploring_meta_tpu_torch.utils.profiling import span, tracing_on
from exploring_meta_tpu_torch.utils.tree import (
    tree_leaves, tree_map, tree_unflatten,
)

# captures and replays since the last reset_counts(), over every loop
COUNTS = {"captures": 0, "replays": 0}


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


def warm_up(device, fn: Callable):
    """``fn()`` eagerly on a new side stream that waits for the current
    one (a capture's warm-up: lazy initialisation and cuDNN's autotuning
    happen here, not inside the capture) -> ``(the stream, fn's
    result)``; the current stream then waits for the side stream."""
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        out = fn()
    torch.cuda.current_stream(device).wait_stream(stream)
    return stream, out


def capture(fn: Callable, stream, generators=(), pool=None):
    """``fn()`` captured on ``stream`` into a new ``CUDAGraph``, with
    ``generators`` registered and the memory in ``pool`` -> ``(the graph,
    fn's outputs, which each replay overwrites)``. Nothing runs and
    nothing is drawn; a capture that fails raises."""
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    with torch.cuda.graph(graph, pool=pool, stream=stream):
        out = fn()
    COUNTS["captures"] += 1
    return graph, out


def marked(fn: Callable, device, sites: list) -> Callable:
    """``fn`` inside a ``graphs.replay`` span with marks on ``device``:
    captured, the marks are the graph's first and last nodes; the span's
    site is appended to ``sites``."""
    def run(*args):
        with span("graphs.replay", device=device) as s:
            out = fn(*args)
        sites.append(s.site)
        return out
    return run


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
        self.traced_graph = None      # the instrumented twin, and its site
        self.traced_site = None

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
        self.stream, _ = warm_up(self.device, self.step)

    def _capture(self, traced: bool = False) -> None:
        with span("graphs.capture"):
            if not traced:
                self.graph, _ = capture(self.step, self.stream,
                                        self.generators)
                return
            sites: list = []
            self.traced_graph, _ = capture(
                marked(self.step, self.device, sites), self.stream,
                self.generators)
            self.traced_site = sites[0]

    def _replay(self) -> None:
        traced = tracing_on()
        if (self.traced_graph if traced else self.graph) is None:
            self._capture(traced)
        graph, site = ((self.traced_graph, self.traced_site) if traced
                       else (self.graph, None))
        with span("graphs.replay", site=site):
            graph.replay()

    def __call__(self, n: int | None = None) -> dict:
        n = self.n_steps if n is None else n
        if not 1 <= n <= self.n_steps:
            raise ValueError(f"a chunk of {n} iterations; this loop runs 1 "
                             f"to {self.n_steps}")
        with span("graphs.chunk", steps=n):
            self.row.zero_()
            for _ in range(n):
                if self.device.type != "cuda":
                    self.step()
                elif self.buffer is None:
                    self._warm_up()
                else:
                    self._replay()
                    COUNTS["replays"] += 1
            rows = self.buffer[:n].clone()
        return {k: rows[:, i] for i, k in enumerate(self.keys)}


def _rows(tree, rows: int | None, fresh: bool = False):
    """Every leaf's first ``rows`` rows (all of them for None), cloned
    when ``fresh``."""
    return tree_map(lambda t: t[:rows].clone() if fresh else t[:rows], tree)


_EAGER = [False]


@contextlib.contextmanager
def run_eagerly():
    """Inside, every :class:`CapturedCalls` call runs its function eagerly
    on the card, as on the CPU, capturing and counting nothing: the
    computation a replay is held against."""
    _EAGER.append(True)
    try:
        yield
    finally:
        _EAGER.pop()


def _runs_eagerly(device) -> bool:
    """Whether a :class:`CapturedCalls` call on ``device`` runs its
    function: on the CPU, and under :func:`run_eagerly`."""
    return device.type != "cuda" or _EAGER[-1]


class CapturedCalls:
    """``calls(key, fn, inputs, rows=None, generator=None)`` ->
    ``fn(*inputs)`` (``fn(generator, *inputs)`` with a generator), every
    output leaf cut to its first ``rows`` rows.

    ``inputs`` is a tuple of trees of tensors on one device, and ``fn``
    returns a tree of tensors computed from them (and from tensors that
    never change, such as a server's params) and from the generator
    alone. On the card a graph is kept per ``key`` (which names ``fn``),
    device, input shapes and dtypes, and whether tracing is on (a traced
    key's graph is the marked twin). The first call at a key copies
    the inputs into static buffers, runs ``fn`` on them eagerly on a side
    stream, captures it right after into a graph, and returns the eager
    result. Every later call copies the inputs into the static buffers,
    replays the graph, and returns clones of the outputs (the next replay
    overwrites them). A graph that draws is captured with a generator of
    its own registered: each replay loads the caller's generator state
    into it and writes the advanced state back, so any generator on the
    device draws, in a replay, what the eager call would draw from it at
    that point of its stream, with no capture of its own. All graphs of
    one object share one memory pool: their outputs are read before the
    next replay, so one graph's scratch may hold another's dead outputs.
    Calls are serialised by a lock (copy-in, replay and clones, and a
    first call's capture), and a call on another stream than the last
    one waits for it, so threads may share one object. A capture that
    fails raises; there is no eager fallback on the card. On the CPU, and
    under :func:`run_eagerly`, ``fn`` runs eagerly and nothing is
    counted."""

    def __init__(self):
        self.graphs: dict = {}
        self.pool = None
        self.lock = threading.Lock()
        self.last_stream: dict = {}

    def __call__(self, key, fn: Callable, inputs: tuple, rows=None,
                 generator=None):
        leaves = tree_leaves(inputs)
        if not all(isinstance(t, torch.Tensor) for t in leaves):
            raise TypeError("a captured call takes and returns tensors")
        call = fn if generator is None else functools.partial(fn, generator)
        device = leaves[0].device
        if _runs_eagerly(device):
            return _rows(call(*inputs), rows)
        traced = tracing_on()
        full = (key, device, tuple((t.shape, t.dtype) for t in leaves),
                traced)
        with self.lock, torch.cuda.device(device):
            stream = torch.cuda.current_stream(device)
            last = self.last_stream.get(device, stream)
            if last != stream:
                stream.wait_stream(last)
            self.last_stream[device] = stream
            entry = self.graphs.get(full)
            if entry is None:
                with span("graphs.capture"):
                    return self._first_call(full, fn, call, inputs, leaves,
                                            rows, generator, traced)
            graph, static, out, own, site = entry
            with span("graphs.copy_in"):
                torch._foreach_copy_(static, leaves)
                if own is not None:
                    own.set_state(generator.get_state())
            with span("graphs.replay", site=site):
                graph.replay()
            COUNTS["replays"] += 1
            with span("graphs.clone_out"):
                if own is not None:
                    generator.set_state(own.get_state())
                return _rows(out, rows, fresh=True)

    def _first_call(self, full, fn, call, inputs, leaves, rows, generator,
                    traced):
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        static = [t.clone(memory_format=torch.contiguous_format)
                  for t in leaves]
        tree = tree_unflatten(inputs, static)
        device = leaves[0].device
        own = None if generator is None else torch.Generator(device=device)
        captured = fn if own is None else functools.partial(fn, own)
        stream, eager = warm_up(device, lambda: call(*tree))
        sites: list = [None]
        if traced:
            captured = marked(captured, device, sites)
        graph, out = capture(lambda: captured(*tree), stream,
                             () if own is None else (own,), self.pool)
        self.graphs[full] = (graph, static, out, own, sites[-1])
        return _rows(eager, rows)


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
