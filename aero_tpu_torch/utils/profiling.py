"""The port's tracer: spans and counters where the fused station's work
happens, off by default.

One tracer per process, ``TRACER``.  Switch it on (``TRACER.on = True``)
before a station is built.  A station built while it is on picks traced
objects (its own calls wrapped, traced framers and burst watchers), one
built while it is off the plain ones, so that off, a call site costs one
boolean test (``if TRACER.on``): no clock read, no profiler range, no
allocation.  Switch it on or off between blocks, never inside one.

On, a span records its name, the block it serves (its parent's where not
given), its parent, and its start and end on ``perf_counter_ns``; while a
``torch.profiler`` runs, it also opens a ``record_function`` range of the
same name under the prefix ``aero.``, so that inside a profiled stretch
host spans and device operations share the profiler's clock.  Spans of
one name under one parent for one block merge into one record, which
sums their durations and counts their calls: per-VFO work inside a drain
is one total per block and stage, not a record per call.  A span given a
``tag`` (a graph capture) is a record of its own.  Records live in flat
arrays, which the garbage collector does not track.

``count(name, n)`` adds to a counter.  ``take()`` returns the records and
counters so far as ``Records`` and clears them; a span still open then
is recorded, whole, in the next ``take()``.  A record's self time is its
duration less what its child spans cover.

The spans and counters of the fused station (``runtime/fused_station.py``
and what it builds) are listed in README.md's operator section;
``station_main --trace`` prints them, and ``chip_smoke.py`` and
``tools/torch_profile_step.py`` split a drain by stage with them.
"""

from __future__ import annotations

import time
from array import array
from dataclasses import dataclass

import torch
from torch.profiler import record_function

PREFIX = "aero."

# whether a torch.profiler is recording
_profiling = torch._C._autograd._profiler_enabled


class _Span:
    """``with TRACER.span(...)``: open on entry, close on exit."""

    __slots__ = ("tracer", "name", "block", "tag", "opened")

    def __init__(self, tracer, name, block, tag):
        self.tracer, self.name, self.block, self.tag = tracer, name, block, tag

    def __enter__(self):
        self.opened = self.tracer.open(self.name, self.block, self.tag)
        return self

    def __exit__(self, *exc):
        if self.opened:
            self.tracer.close()
        return False


@dataclass
class Records:
    """What ``Tracer.take()`` returns.  Record ``i`` is a span or merged
    spans: ``names[name[i]]``, the ``block`` it serves (-1: none), its
    ``parent`` record (-1: a root), the first start and last end
    (``start``, ``end``, ns), the summed duration ``total`` and the part
    of it its children cover ``child`` (ns), and its ``calls``; ``tags``
    maps a record to its tag; ``counts`` holds the counters."""

    names: tuple
    name: array
    block: array
    parent: array
    start: array
    end: array
    total: array
    child: array
    calls: array
    tags: dict
    counts: dict

    def __len__(self) -> int:
        return len(self.name)

    def label(self, i: int) -> str:
        return self.names[self.name[i]]

    def self_ns(self, i: int) -> int:
        return self.total[i] - self.child[i]

    def stages(self) -> dict:
        """name -> [self ns, total ns, calls], summed over records."""
        out = {}
        for i in range(len(self)):
            s = out.setdefault(self.label(i), [0, 0, 0])
            s[0] += self.self_ns(i)
            s[1] += self.total[i]
            s[2] += self.calls[i]
        return out

    def by_block(self, name: str) -> dict:
        """block -> self ns of the records named ``name``."""
        out = {}
        for i in range(len(self)):
            if self.label(i) == name:
                out[self.block[i]] = out.get(self.block[i], 0) + \
                    self.self_ns(i)
        return out

    def per_block_ms(self) -> dict:
        """The stats line's reading: blocks drained, each stage's self ms
        per drained block, and the counters."""
        n = self.counts.get("blocks.drained", 0)
        return {"blocks": n,
                "self_ms": {k: round(v[0] / 1e6 / n, 4)
                            for k, v in sorted(self.stages().items())}
                if n else {},
                "counts": dict(sorted(self.counts.items()))}


class Tracer:
    """Spans and counters in flat arrays (see the module docstring)."""

    def __init__(self, clock=time.perf_counter_ns):
        self.on = False
        self.clock = clock
        self._names = []        # name id -> name
        self._ids = {}          # name -> name id
        self._labels = []       # name id -> profiler range name
        # open spans, innermost last: record, start, children's ns, and
        # the profiler range or None
        self._open = array("q")
        self._t0 = array("q")
        self._kids = array("q")
        self._ranges = []
        self._clear()

    def _clear(self) -> None:
        (self._name, self._block, self._parent, self._start, self._end,
         self._total, self._child, self._calls) = (
            array("q") for _ in range(8))
        self._tags = {}
        self._merge = {}        # (parent, block, name) as an int -> record
        self._counts = array("q")

    def _id(self, name: str) -> int:
        i = self._ids.get(name)
        if i is None:
            i = self._ids[name] = len(self._names)
            self._names.append(name)
            self._labels.append(PREFIX + name)
        return i

    def _record(self, nid: int, block: int, parent: int, t: int,
                tag, key=None) -> int:
        """A new record of a span; ``key`` merges later spans into it."""
        rec = len(self._name)
        self._name.append(nid)
        self._block.append(block)
        self._parent.append(parent)
        self._start.append(t)
        self._end.append(t)
        for a in (self._total, self._child, self._calls):
            a.append(0)
        if key is not None:
            self._merge[key] = rec
        if tag is not None:
            self._tags[rec] = tag
        return rec

    def span(self, name: str, block: int | None = None, tag=None) -> _Span:
        """A span as a context manager."""
        return _Span(self, name, block, tag)

    def open(self, name: str, block: int | None = None, tag=None) -> bool:
        """Open a span (``close()`` closes the innermost); False, and
        nothing opened, while the tracer is off."""
        if not self.on:
            return False
        # the clock is read first on opening and last on closing: a
        # span's time includes what tracing it costs, and its parent's
        # self time none of it
        t = self.clock()
        nid = self._ids.get(name)
        if nid is None:
            nid = self._id(name)
        parent = self._open[-1] if self._open else -1
        if block is None:
            block = self._block[parent] if parent >= 0 else -1
        if tag is None:
            key = (parent + 1) << 52 | (block + 1) << 12 | nid
            rec = self._merge.get(key)
            if rec is None:
                rec = self._record(nid, block, parent, t, None, key)
        else:
            rec = self._record(nid, block, parent, t, tag)
        self._open.append(rec)
        self._t0.append(t)
        self._kids.append(0)
        rng = None
        if _profiling():
            rng = record_function(self._labels[nid])
            rng.__enter__()
        self._ranges.append(rng)
        return True

    def close(self) -> None:
        """Close the innermost open span."""
        if not self._open:
            return
        rng = self._ranges.pop()
        if rng is not None:
            rng.__exit__(None, None, None)
        rec, t0, kids = self._open.pop(), self._t0.pop(), self._kids.pop()
        self._calls[rec] += 1
        self._child[rec] += kids
        t = self.clock()
        self._total[rec] += t - t0
        self._end[rec] = t
        if self._kids:
            self._kids[-1] += t - t0

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name`` (nothing while off)."""
        if not self.on:
            return
        i = self._id(name)
        c = self._counts
        if i >= len(c):
            c.extend([0] * (i + 1 - len(c)))
        c[i] += n

    def take(self) -> Records:
        """The records and counters so far; clears them.  Spans still
        open get fresh records, to which they add their whole duration
        when they close."""
        out = Records(tuple(self._names), self._name, self._block,
                      self._parent, self._start, self._end, self._total,
                      self._child, self._calls, self._tags,
                      {self._names[i]: n for i, n in enumerate(self._counts)
                       if n})
        still = list(self._open)
        self._clear()
        for depth, rec in enumerate(still):
            self._open[depth] = self._record(out.name[rec], out.block[rec],
                                             depth - 1, out.start[rec],
                                             out.tags.get(rec))
        self._merge.clear()
        return out


TRACER = Tracer()


def traced(fn, name: str):
    """``fn`` with each call a span ``name`` serving its parent's block
    (for an object built while the tracer is on)."""
    def call(*args, **kw):
        with TRACER.span(name):
            return fn(*args, **kw)
    return call
