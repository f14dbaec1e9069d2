"""One device step as one CUDA-graph replay: the port's counterpart of
``jax.jit`` with the state donated.

A step is a function ``fn(state, *args, **static) -> (new_state,
outputs)``: the state a tree (dicts, NamedTuples, lists, tuples) of
tensors on one device, or ``()`` for a function without state; the
arguments that are tensors are its inputs, every other argument (and
every keyword) is static, the counterpart of ``jax.jit``'s
``static_argnames``: part of the key a graph is cached under, and so
hashable; the outputs a tensor or a tree of tensors.  ``GraphedStep``
owns the state in static buffers and runs the step so:

- **on a CUDA device**, the first call for a key (the inputs' shapes and
  dtypes and the static values) copies the inputs into static input
  buffers, warms the step up on a side stream (on clones of the state,
  whose results are thrown away: a warm-up advances no carry), and
  captures it into a ``torch.cuda.CUDAGraph`` whose last operations copy
  the new state into the static state buffers (the counterpart of
  donation).  Every call
  then copies its inputs into the static buffers, replays the graph, and
  returns copies of the outputs, which the next replay cannot overwrite;
- **on the CPU, or inside ``device.disable_graphs()``**, the step runs
  eagerly through the same buffers: the inputs are copied in, the new
  state is written back in place and the outputs are copied out.  The
  CPU tests exercise that discipline; only capture and replay need the
  card.

A capture that fails (a host sync, a pageable copy, anything a stream
capture refuses) raises ``CaptureError`` naming the step and the cause;
nothing carries on eagerly.  No ``torch.compile``: it would fuse ops and
round float32 differently from the eager step (and from JAX's CPU
compiler, which the parity tests hold the port to).  A replay runs the
kernels of the eager step with the same launch parameters, so the two
give the same bytes.

``state`` is the one way in and out of the static state: reading it gives
the live buffers (valid until the next call), ``snapshot()`` a copy, and
assigning it copies a tree of the same layout into the buffers (the graphs
stay valid) or, for another layout, adopts copies of the tree and drops
the graphs, so that the next call captures again.

A hand kernel's wrapper counts its launches through ``count_launch``: a
replay runs no host code, so a launch recorded in a capture is counted
at each replay of that graph instead, and the warm-up's launches, whose
results are thrown away, not at all.  A graphed run and an eager run of
the same work so count the same launches.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging

import torch

from aero_tpu_torch.device import graphs_enabled, set_fp32_precision
from aero_tpu_torch.utils.profiling import TRACER
from aero_tpu_torch.utils.trees import tree_leaves, tree_map

log = logging.getLogger(__name__)

# eager steps on a side stream before a capture (torch.cuda.graphs' recipe)
_WARMUP = 2


# while a GraphedStep warms up or captures: the list that collects the
# launch counters of the hand kernels it runs (None: count at once)
_LAUNCHES = contextvars.ContextVar("aero_tpu_torch_capture_launches",
                                   default=None)


class CaptureError(RuntimeError):
    """A step could not be captured into a CUDA graph."""


def count_launch(count) -> None:
    """Where a hand kernel's wrapper launches its kernel: ``count()`` (a
    callable that adds one to the wrapper's count) runs now, or, inside a
    ``GraphedStep``'s capture, at each replay of the graph (a warm-up's
    launches are not counted)."""
    tally = _LAUNCHES.get()
    if tally is None:
        count()
    else:
        tally.append(count)


@contextlib.contextmanager
def _collecting_launches(tally: list):
    token = _LAUNCHES.set(tally)
    try:
        yield tally
    finally:
        _LAUNCHES.reset(token)


def _layout(tree):
    """What a static buffer must match to take a tree's values in place:
    the tree's structure (dict keys in any order) and each leaf's shape,
    dtype and device."""
    if isinstance(tree, dict):
        return tuple(sorted(((repr(k), _layout(v)) for k, v in tree.items()),
                            key=lambda kv: kv[0]))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_layout(v) for v in tree))
    return (tuple(tree.shape), tree.dtype, tree.device)


def _write_back(static, new) -> None:
    """Copy the tree ``new`` into the static buffers ``static`` in place,
    leaf by leaf (dict leaves by key).  A leaf that is its own buffer is
    left; a leaf that shares memory with any buffer (a view) is copied
    aside first, so no write can reach what a later leaf still reads."""
    pairs = []
    tree_map(lambda s, n: pairs.append((s, n)), static, new)
    storages = {s.untyped_storage().data_ptr() for s, _ in pairs}
    pairs = [(s, n.clone() if n.untyped_storage().data_ptr() in storages
              else n) for s, n in pairs if n is not s]
    for s, n in pairs:
        s.copy_(n)


class _Graph:
    """A captured step: its graph, static inputs and outputs, and the
    launch counters of the hand kernels captured in it."""

    def __init__(self, graph, inputs, outputs, launches):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.launches = launches

    def replay(self) -> None:
        self.graph.replay()
        for count in self.launches:
            count()


def _key(args, static) -> tuple:
    """What a graph is cached under: each input's shape and dtype, each
    static argument's value."""
    return (tuple((torch.Tensor, tuple(a.shape), a.dtype)
                  if isinstance(a, torch.Tensor) else a for a in args),
            tuple(sorted(static.items())))


def _key_text(args, static) -> str:
    """A key as text: each input's shape and dtype, each static value."""
    parts = ["x".join(map(str, a.shape)) + " " + str(a.dtype).split(".")[-1]
             if isinstance(a, torch.Tensor) else repr(a) for a in args]
    parts += [f"{k}={v!r}" for k, v in sorted(static.items())]
    return "(" + ", ".join(parts) + ")"


def _bind(args, inputs) -> list:
    """``args`` with its tensors replaced, in order, by ``inputs``."""
    it = iter(inputs)
    return [next(it) if isinstance(a, torch.Tensor) else a for a in args]


class GraphedStep:
    """``fn(state, *args, **static) -> (new_state, outputs)`` with its
    state in static buffers, replayed as one CUDA graph per key on a CUDA
    device (see the module docstring).  ``name`` appears in logs and in a
    capture's error; ``captures`` counts the graphs captured and
    ``replays`` the replays.  A step without state takes ``state=()`` and
    names its ``device``.  Inputs may lie on any device: they are copied
    into static buffers on the step's device."""

    def __init__(self, fn, state, name: str, device=None):
        self.fn = fn
        self.name = name
        self.captures = 0
        self.replays = 0
        self._graphs = {}
        self._eager_io = {}
        self._state = None
        self.device = None if device is None else torch.device(device)
        self.state = state

    @property
    def state(self):
        """The live static state buffers: valid until the next call."""
        return self._state

    @state.setter
    def state(self, tree):
        if self._state is not None and _layout(tree) == _layout(self._state):
            _write_back(self._state, tree)
            return
        self._state = tree_map(
            lambda t: t.detach().clone(memory_format=torch.contiguous_format),
            tree)
        leaves = tree_leaves(self._state)
        if leaves:
            self.device = leaves[0].device
        elif self.device is None:
            raise ValueError(f"step {self.name!r} has no state: name its "
                             "device")
        self._graphs.clear()
        self._eager_io.clear()

    def snapshot(self):
        """A copy of the state that later calls leave as it is."""
        return tree_map(torch.clone, self._state)

    @property
    def keys(self) -> int:
        """The keys that have a captured graph."""
        return len(self._graphs)

    def __call__(self, *args, out=None, **static):
        """One step on ``args``; returns the outputs (copied into ``out``
        where given, a tensor like the single output tensor)."""
        key = _key(args, static)
        inputs = [a for a in args if isinstance(a, torch.Tensor)]
        if self.device.type != "cuda" or not graphs_enabled():
            return self._eager(key, args, inputs, static, out)
        g = self._graphs.get(key)
        if g is None:
            capture = self._traced_capture if TRACER.on else self._capture
            g = self._graphs[key] = capture(args, inputs, static)
        for s, x in zip(g.inputs, inputs):
            s.copy_(x)
        g.replay()
        self.replays += 1
        return _copy_out(g.outputs, out)

    def _static_inputs(self, inputs) -> list:
        return [torch.empty(x.shape, dtype=x.dtype,
                            device=self.device).copy_(x) for x in inputs]

    def _eager(self, key, args, inputs, static, out):
        io = self._eager_io.get(key)
        if io is None:
            io = self._eager_io[key] = [self._static_inputs(inputs), None]
        else:
            for s, x in zip(io[0], inputs):
                s.copy_(x)
        new, outputs = self.fn(self._state, *_bind(args, io[0]), **static)
        _write_back(self._state, new)
        if io[1] is None:
            io[1] = tree_map(torch.empty_like, outputs)
        tree_map(lambda s, o: s.copy_(o), io[1], outputs)
        return _copy_out(io[1], out)

    def _traced_capture(self, args, inputs, static) -> _Graph:
        """``_capture`` as a ``graph.capture`` span tagged with the step's
        name and key, counted in ``graph.captures``."""
        with TRACER.span("graph.capture",
                         tag=f"{self.name} {_key_text(args, static)}"):
            g = self._capture(args, inputs, static)
        TRACER.count("graph.captures")
        return g

    def _capture(self, args, inputs, static) -> _Graph:
        dev = self.device
        # the warm-up builds every per-device constant (the lru_cached
        # tables), cuFFT plan and cuBLAS/cuDNN handle outside the capture,
        # and makes a hand kernel's one-time device queries and settings;
        # cuDNN picks its algorithm by heuristics, the same in both modes
        set_fp32_precision()
        torch.backends.cudnn.benchmark = False
        static_in = self._static_inputs(inputs)
        bound = _bind(args, static_in)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), _collecting_launches([]):
            for _ in range(_WARMUP):
                self.fn(self.snapshot(), *bound, **static)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=side), \
                    _collecting_launches([]) as launches:
                new, outputs = self.fn(self._state, *bound, **static)
                _write_back(self._state, new)
        except RuntimeError as e:
            raise CaptureError(
                f"CUDA graph capture of step {self.name!r} failed: "
                f"{type(e).__name__}: {e}") from e
        torch.cuda.current_stream(dev).wait_stream(side)
        self.captures += 1
        log.info("captured step %s as a CUDA graph (%d for it so far)",
                 self.name, self.captures)
        return _Graph(graph, static_in, outputs, launches)


def stateless(fn, name: str, device) -> GraphedStep:
    """``fn(*args, **static) -> outputs``, a function without state, as a
    ``GraphedStep`` on ``device`` (its ``jax.jit``: one graph per key)."""
    def step(state, *args, **static):
        return state, fn(*args, **static)
    return GraphedStep(step, (), name, device=device)


def _copy_out(outputs, out):
    if out is not None:
        return out.copy_(outputs)
    return tree_map(torch.clone, outputs)
