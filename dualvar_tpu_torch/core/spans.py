"""The port's spans and counters: what a train step waits for, what work it
launches, and what set-up is made of.

``span(name, device=False)`` is a context manager around one stage of the
program. Each span keeps its name, its start and end on the host clock
(``time.perf_counter_ns``), the span that encloses it and the step it
belongs to. The span named ``dualvar.step`` (``STEP``), opened by
``train/pretrain.py:make_train_step`` around each call, starts a step and
gives it its id; a span outside a step belongs to none.

Always on, and only on the host: the record holds the last ``RING``
finished steps, and apart from them the first finished span of each name,
so a set-up span and the first step (the warm-up of the step's shapes)
outlive the ring, and the total of each ``dualvar.setup.*`` name over the
process, inside a step or outside one. Only while a torch profiler runs
does a span also open a ``record_function`` of its name, which puts it in
the device trace beside the kernels it launched, and a span with
``device=True`` also records a CUDA event pair on the current stream, read
lazily by ``steps()``. With no profiler neither is touched: a span then
costs two clock reads and a few list operations.

Naming: ``dualvar.step.<stage>`` for the step's stages,
``dualvar.losses`` and ``dualvar.loss.<term>`` for the heads and loss
terms, ``dualvar.moco.<part>``, ``dualvar.setup.<part>`` for set-up, and
``dualvar.sync.<site>`` (``sync(site)``) around each call on the step's
path that makes the host wait for the device, each also counted as
``host_syncs`` in the open step (a sync outside a step is spanned, not
counted). On the CPU the same sites are spanned and counted; there
they wait for nothing.

``count(name)`` adds to a count of the open step, and outside a step does
nothing: ``host_syncs`` (``sync``) and ``nchw_convs``
(``models/layers.py:Conv3d``, a convolution whose 5-D input is not in
``channels_last_3d`` memory: on the card, one that cuDNN transposes).

The record is process-wide plain Python, with no lock: spans are opened on
the thread that runs the step. ``reset()`` empties it (the tests).
"""

from __future__ import annotations

import collections
import time

import torch
from torch.autograd import profiler as _profiler

STEP = "dualvar.step"
SYNC = "dualvar.sync."
SETUP = "dualvar.setup."
RING = 256


class _Step:
    __slots__ = ("id", "profiled", "span", "spans", "counts")

    def __init__(self, step_id: int, profiled: bool, span: "_Span"):
        self.id, self.profiled, self.span = step_id, profiled, span
        self.spans: list[_Span] = []  # in the order they opened
        self.counts: dict[str, int] = {}


class _Record:
    def __init__(self):
        self.stack: list[_Span] = []  # the open spans, outermost first
        self.step: _Step | None = None
        self.ring: collections.deque = collections.deque(maxlen=RING)
        self.first: dict[str, _Span] = {}
        self.setup: dict[str, int] = {}  # name -> host ns over the process
        self.next_id = 0


_record = _Record()


class _Span:
    __slots__ = ("name", "device", "start", "end", "parent", "step",
                 "events", "rf")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device
        self.events = self.rf = None

    def __enter__(self):
        r = _record
        self.parent = r.stack[-1] if r.stack else None
        if self.name == STEP and r.step is None:
            r.step = _Step(r.next_id, _profiler._is_profiler_enabled, self)
            r.next_id += 1
        self.step = r.step
        if self.step is not None:
            self.step.spans.append(self)
        r.stack.append(self)
        if _profiler._is_profiler_enabled:
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()
            if self.device and torch.cuda.is_initialized():
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                self.events[0].record()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if self.rf is not None:
            if self.events is not None:
                self.events[1].record()
            self.rf.__exit__(None, None, None)
            self.rf = None
        r = _record
        r.stack.pop()
        if self.step is not None and self.step.span is self:
            r.ring.append(self.step)
            r.step = None
        if self.name not in r.first:
            r.first[self.name] = self
        if self.name.startswith(SETUP):
            r.setup[self.name] = (r.setup.get(self.name, 0)
                                  + self.end - self.start)
        return False

    def host_ms(self) -> float:
        return (self.end - self.start) / 1e6

    def stream_ms(self) -> float | None:
        if self.events is None:
            return None
        self.events[1].synchronize()
        return self.events[0].elapsed_time(self.events[1])


def span(name: str, device: bool = False) -> _Span:
    """A span of ``name`` around a ``with`` block; ``device=True`` times
    the block on the current CUDA stream as well, while a profiler runs."""
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the count ``name`` of the open step; outside a step,
    nothing."""
    step = _record.step
    if step is not None:
        step.counts[name] = step.counts.get(name, 0) + n


def sync(site: str) -> _Span:
    """The span ``dualvar.sync.<site>`` around a call that makes the host
    wait for the device, counted as ``host_syncs`` in the open step."""
    count("host_syncs")
    return _Span(SYNC + site, False)


def steps() -> list[dict]:
    """The finished steps in the ring, oldest first, each a dict: ``id``;
    ``profiled`` (a profiler ran when it started); by span name, summed
    over the step and in the order the names first opened, ``host_ms``,
    ``self_ms`` (less the time of the spans it encloses), ``stream_ms``
    (``device=True`` spans of a profiled step on the card) and ``syncs``
    (the ``dualvar.sync.*`` spans it encloses, or is); ``counts``."""
    return [_view(s) for s in _record.ring]


def _view(step: _Step) -> dict:
    host = collections.Counter()
    inner = collections.Counter()  # id(span) -> its children's host ms
    own = collections.Counter()
    stream = collections.Counter()
    syncs = collections.Counter()
    for s in step.spans:
        ms = s.host_ms()
        host[s.name] += ms
        if s.parent is not None:
            inner[id(s.parent)] += ms
        t = s.stream_ms()
        if t is not None:
            stream[s.name] += t
        if s.name.startswith(SYNC):
            p = s
            while p is not None:
                syncs[p.name] += 1
                p = p.parent
    for s in step.spans:
        own[s.name] += s.host_ms() - inner[id(s)]
    return {"id": step.id, "profiled": step.profiled, "host_ms": dict(host),
            "self_ms": dict(own), "stream_ms": dict(stream),
            "syncs": dict(syncs), "counts": dict(step.counts)}


def first_ms(name: str) -> float | None:
    """Host ms of the first finished span of ``name``, or None."""
    s = _record.first.get(name)
    return s.host_ms() if s is not None else None


def setup_ms(name: str) -> float | None:
    """Host ms of every finished span of ``name``, a ``dualvar.setup.*``
    name, over the process, or None."""
    ns = _record.setup.get(name)
    return ns / 1e6 if ns is not None else None


def summary(views: list[dict]) -> list[str]:
    """The operator's lines over ``views`` (``steps()``' dicts): one a span
    name, in the order the names first opened, with its means a step."""
    if not views:
        return []
    names = list(dict.fromkeys(n for v in views for n in v["host_ms"]))
    n = len(views)

    def mean(key, name):
        return sum(v[key].get(name, 0.0) for v in views) / n

    lines = []
    for name in names:
        stream = (f"{mean('stream_ms', name):.3f} ms"
                  if any(name in v["stream_ms"] for v in views) else "-")
        lines.append(f"{name}: host {mean('host_ms', name):.3f} ms, self "
                     f"{mean('self_ms', name):.3f} ms, stream {stream}, "
                     f"syncs {mean('syncs', name):g} a step over {n}")
    return lines


def reset() -> None:
    """Forget every span, step and count."""
    global _record
    _record = _Record()
