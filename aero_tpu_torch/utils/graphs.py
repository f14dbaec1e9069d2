"""One device step as one CUDA-graph replay: the port's counterpart of
``jax.jit`` with the state donated.

A step is a function ``fn(state, *inputs) -> (new_state, outputs)``: the
state a tree (dicts, NamedTuples, lists, tuples) of tensors on one device,
the inputs tensors, the outputs a tensor or a tree of tensors.
``GraphedStep`` owns the state in static buffers and runs the step so:

- **on a CUDA device**, the first call for a set of input shapes and
  dtypes copies the inputs into static input buffers, warms the step up
  on a side stream (on clones of the state, whose results are thrown
  away: a warm-up advances no carry), and captures it into a
  ``torch.cuda.CUDAGraph`` whose last operations copy the new state into
  the static state buffers (the counterpart of donation).  Every call
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
"""

from __future__ import annotations

import logging

import torch

from aero_tpu_torch.device import graphs_enabled, set_fp32_precision
from aero_tpu_torch.utils.trees import tree_leaves, tree_map

log = logging.getLogger(__name__)

# eager steps on a side stream before a capture (torch.cuda.graphs' recipe)
_WARMUP = 2


class CaptureError(RuntimeError):
    """A step could not be captured into a CUDA graph."""


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
    """A captured step: its graph, static inputs and static outputs."""

    def __init__(self, graph, inputs, outputs):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs


class GraphedStep:
    """``fn(state, *inputs) -> (new_state, outputs)`` with its state in
    static buffers, replayed as one CUDA graph per input signature on a
    CUDA device (see the module docstring).  ``name`` appears in logs and
    in a capture's error; ``captures`` counts the graphs captured.  Inputs
    may lie on any device: they are copied into static buffers on the
    state's device."""

    def __init__(self, fn, state, name: str):
        self.fn = fn
        self.name = name
        self.captures = 0
        self._graphs = {}
        self._eager_io = {}
        self._state = None
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
        self.device = tree_leaves(self._state)[0].device
        self._graphs.clear()
        self._eager_io.clear()

    def snapshot(self):
        """A copy of the state that later calls leave as it is."""
        return tree_map(torch.clone, self._state)

    def __call__(self, *inputs, out=None):
        """One step on ``inputs``; returns the outputs (copied into
        ``out`` where given, a tensor like the single output tensor)."""
        key = tuple((tuple(x.shape), x.dtype) for x in inputs)
        if self.device.type != "cuda" or not graphs_enabled():
            return self._eager(key, inputs, out)
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._capture(inputs)
        for s, x in zip(g.inputs, inputs):
            s.copy_(x)
        g.graph.replay()
        return _copy_out(g.outputs, out)

    def _static_inputs(self, inputs) -> list:
        return [torch.empty(x.shape, dtype=x.dtype,
                            device=self.device).copy_(x) for x in inputs]

    def _eager(self, key, inputs, out):
        io = self._eager_io.get(key)
        if io is None:
            io = self._eager_io[key] = [self._static_inputs(inputs), None]
        else:
            for s, x in zip(io[0], inputs):
                s.copy_(x)
        new, outputs = self.fn(self._state, *io[0])
        _write_back(self._state, new)
        if io[1] is None:
            io[1] = tree_map(torch.empty_like, outputs)
        tree_map(lambda s, o: s.copy_(o), io[1], outputs)
        return _copy_out(io[1], out)

    def _capture(self, inputs) -> _Graph:
        dev = self.device
        # the warm-up builds every per-device constant (the lru_cached
        # tables), cuFFT plan and cuBLAS/cuDNN handle outside the capture;
        # cuDNN picks its algorithm by heuristics, the same in both modes
        set_fp32_precision()
        torch.backends.cudnn.benchmark = False
        static_in = self._static_inputs(inputs)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(_WARMUP):
                self.fn(self.snapshot(), *static_in)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=side):
                new, outputs = self.fn(self._state, *static_in)
                _write_back(self._state, new)
        except RuntimeError as e:
            raise CaptureError(
                f"CUDA graph capture of step {self.name!r} failed: "
                f"{type(e).__name__}: {e}") from e
        torch.cuda.current_stream(dev).wait_stream(side)
        self.captures += 1
        log.info("captured step %s as a CUDA graph (%d for it so far)",
                 self.name, self.captures)
        return _Graph(graph, static_in, outputs)


def _copy_out(outputs, out):
    if out is not None:
        return out.copy_(outputs)
    return tree_map(torch.clone, outputs)
