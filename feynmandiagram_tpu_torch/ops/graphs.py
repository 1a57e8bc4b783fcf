"""CUDA graphs: the port's counterpart of the JAX package's ``jax.jit``.

The JAX package compiles a whole pass into one device program
(``jax.jit``).  On CUDA the counterpart is a ``torch.cuda.CUDAGraph``
captured from a body that allocates nothing outside the graph's memory pool
and never waits for the host: the static passes of ``ops.evaluator`` and
``backends.compile``.

``capture`` warms a body up and captures it; ``Captured`` replays one at
the shapes of its last call and re-captures when they change;
``SeededGraph`` replays a body that draws from generators, each seeded
before the replay; ``one_shape`` holds one such graph at a time.

A replay runs no Python, so ``capture`` keeps the graph's launch manifest
(``utils.profiling.capturing``: each kernel launch of the body, with its
symbol and the path of the scopes it ran in) as ``graph.manifest``, and
every replay goes through ``replay``: it runs in the scope
``replay:<name>`` and adds the manifest's launches to the kernels' launch
counters (``level_gather_reduce.launches``), which so count the device's
launches, eager or replayed.  The scopes inside the body name the
manifest's launches; a trace of a replay holds its kernels' records, and
the manifest tells which launch each one is.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from ..utils import profiling


def require_cuda(device: torch.device, what: str) -> None:
    """Raise ``ValueError`` unless ``device`` is a CUDA device: a captured
    pass has no counterpart elsewhere, and nothing runs eagerly in its
    place."""
    if device.type != "cuda":
        raise ValueError(f"{what}(jit=True) captures a CUDA graph and needs a CUDA device, "
                         f"not {device}")


def capture(body: Callable[[], torch.Tensor],
            generators: Sequence[torch.Generator] = ()) -> Tuple[torch.cuda.CUDAGraph,
                                                                 torch.Tensor]:
    """Run ``body`` once on a side stream, then capture a second run as one
    CUDA graph; return the graph and what the captured run returned, whose
    memory each replay overwrites.

    The first run builds what is built at first use (the kernels' library,
    cuBLAS's workspace, lazily loaded modules), which capture forbids.
    ``generators`` are registered with the graph, so that each replay draws
    from each one's state at replay time and moves it on.  The first run
    counts its launches; the captured one runs nothing on the device and
    counts none: each replay (``replay``) counts the graph's manifest."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    with profiling.capturing() as manifest:
        with torch.cuda.graph(graph):
            out = body()
    graph.manifest = manifest
    # a replay writes into the buffers that body's closure holds (a static
    # w, the draws), which live outside the graph's pool: they must live
    # as long as the graph, or the allocator hands their memory to others
    graph.body = body
    return graph, out


def replay(graph, iters: int = 1) -> None:
    """``iters`` replays of ``graph``, each in the scope ``replay:<name>``;
    the kernels' launch counters then grow by ``iters`` times its manifest
    (a graph that kept none, such as a stand-in's, counts nothing)."""
    manifest = getattr(graph, "manifest", None)
    span = manifest.span if manifest is not None else "replay"
    for _ in range(iters):
        with profiling.scope(span):
            graph.replay()
    profiling.replayed(manifest, iters)


def _load(static: torch.Tensor, value) -> None:
    if isinstance(value, torch.Tensor):
        static.copy_(value)
    else:
        static.fill_(value)     # a number: a kernel argument, no copy from the host


class Captured:
    """``f(*inputs) -> a fresh tensor``, replayed from one CUDA graph.

    ``prepare(*inputs)`` returns the static inputs (tensors on the card, one
    for each input: a tensor is copied in, a number filled in) and the body,
    a function of no arguments that reads only those and returns the output.
    At the first call, and whenever an input's shape or dtype changes, the
    previous graph and its buffers are dropped and ``prepare`` builds new
    ones, which ``capture`` captures: one input signature is held at a
    time.  Each call loads the inputs, replays, and returns a copy of the
    output, so that no later call overwrites a result (the JAX semantics).
    """

    def __init__(self, prepare: Callable[..., Tuple[List[torch.Tensor], Callable]]):
        self._prepare = prepare
        self._key = None
        self._state = None      # (static inputs, graph, output)

    def __call__(self, *inputs) -> torch.Tensor:
        key = tuple((tuple(x.shape), x.dtype, x.device) if isinstance(x, torch.Tensor)
                    else type(x) for x in inputs)
        if key != self._key:
            self._key = self._state = None      # frees the old graph and buffers first
            static, body = self._prepare(*inputs)
            for s, x in zip(static, inputs):
                _load(s, x)
            graph, out = capture(body)
            self._state, self._key = (static, graph, out), key
        static, graph, out = self._state
        for s, x in zip(static, inputs):
            _load(s, x)
        replay(graph)
        return out.clone()


def one_shape(build: Callable):
    """``get(key)``: what ``build(key)`` returned, held for one key at a
    time; a new key drops the old value (its graph and buffers) before it
    builds, as ``Captured`` does for a new input signature."""
    held = {}

    def get(key):
        if key not in held:
            held.clear()
            held[key] = build(key)
        return held[key]

    return get


class SeededGraph:
    """``body`` captured once with ``generators`` registered with the graph.

    ``replay(seeds)`` seeds each generator with its seed and replays: the
    draws are those of an eager run of ``body`` from generators seeded so
    (a replay reads each generator's state at replay time).  It returns the
    static output, which the next replay overwrites."""

    def __init__(self, body: Callable[[], torch.Tensor],
                 generators: Sequence[torch.Generator]):
        self.generators = list(generators)
        self.graph, self.out = capture(body, generators=self.generators)

    def replay(self, seeds: Sequence[int]) -> torch.Tensor:
        for gen, seed in zip(self.generators, seeds, strict=True):
            gen.manual_seed(seed)
        replay(self.graph)
        return self.out
