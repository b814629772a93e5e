"""Spans, device events and counters of the codec, kept in memory.

Tracing is on while a ``torch.profiler`` records (read through the
profiler's own enabled flag) and inside :func:`recording`; nowhere else.
With it off, :func:`span` and :func:`device` read that flag and return one
shared null context: no record, no CUDA event, no profiler call.

With it on:

* a span records its name (``dr.<name>``), its start and end
  (``time.perf_counter_ns``), its parent, a call id shared by every span
  under one top-level span, and its attributes (``rows``, ``length``:
  samples per row, ``words``: the word cap or plane width, ``chunks``).
  Under a profiler it also opens the profiler's annotation ``dr.<name>``
  (``_RecordFunctionFast``: a CPU op, lighter than ``record_function``'s
  user range), so it lies on the profiler's timeline beside the kernels
  it launched. Its start and end leave out its own
  bookkeeping and annotation; its outer start and end hold them, and its
  ``tracer_ns`` is the tracer's own time inside its start and end (its
  children's bookkeeping, their own ``tracer_ns``, its device events):
  :func:`host_ns` leaves that out, and :func:`self_ns` its children whole.
* :func:`device` records a pair of timing CUDA events on the current
  stream around device work, attached to the innermost open span; their
  elapsed time is resolved by :func:`snapshot`, never on the call's path.
* the most recent :data:`RING` top-level calls are kept with all their
  spans; a call that falls out counts in ``spans_dropped``.

:data:`counters` are always on: rows encoded and encoded again past the
word cap, rows decoded and decoded again after the split decode flagged
them, ``rows_prefiltered`` and ``rows_prefilter_inverted``, the rows
through the generic pre-filter's forward FIR and its inverse (never the
delta, which B1 and B2 fuse), chunks re-encoded by verification, calls
dropped from the ring, and
``tiles_rejoined``, the tiles that B2's check walked again from their
true entry phase (``csrc/unpack.cu``). That one the kernels add on the
card, to a device scalar that no call reads back: :func:`snapshot` reads
it into :data:`counters`, once, with the device events.
Kernel launches stay counted in ``ops._kernels.launches``;
:func:`snapshot` reports them beside these.

:func:`calls`, :func:`self_ms`, :func:`host_ms` and :func:`event_ms` read
a snapshot: the calls of one top-level span and row count, and the median
over them of the top's self time, a span's host time or a device event.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import statistics
import threading
import time

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

#: top-level calls kept, each with all its spans
RING = 4096

#: always-on counts, by name (see the module docstring)
counters: collections.Counter = collections.Counter()

_NULL = contextlib.nullcontext()
_recording = 0  # depth of open recording() blocks
_ring: collections.deque = collections.deque()
_calls = itertools.count()
_local = threading.local()  # .stack: the open spans of this thread


def on() -> bool:
    """Whether spans and device events record now."""
    return bool(_recording or _profiler._is_profiler_enabled)


@contextlib.contextmanager
def recording():
    """Turn tracing on inside the block, without a profiler."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


class Span:
    """One recorded span; the context manager :func:`span` returns when
    tracing is on. Attributes may be set inside the block."""

    __slots__ = ("name", "rows", "length", "words", "chunks", "start",
                 "end", "outer_start", "outer_end", "tracer_ns", "parent",
                 "call", "events", "_rf")

    def __init__(self, name, rows, length, words, chunks):
        self.name = "dr." + name
        self.rows, self.length, self.words, self.chunks = (rows, length,
                                                           words, chunks)
        self.end = None
        self.tracer_ns = 0
        self.events = []  # [name, start event, end event or elapsed ms]
        self._rf = None

    def __enter__(self) -> "Span":
        self.outer_start = time.perf_counter_ns()
        if _profiler._is_profiler_enabled:
            self._rf = _RecordFunctionFast(self.name)
            self._rf.__enter__()
        stack = _stack()
        if stack:
            self.parent = stack[-1]
            self.call = self.parent.call
            self.call.append(self)
        else:
            self.parent = None
            self.call = _Call(next(_calls), self)
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter_ns()
        _stack().pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self.outer_end = time.perf_counter_ns()
        if self.parent is not None:
            self.parent.tracer_ns += (self.outer_end - self.outer_start
                                      - self.end + self.start
                                      + self.tracer_ns)
        else:
            _ring.append(self.call)
            if len(_ring) > RING:
                _ring.popleft()
                counters["spans_dropped"] += 1
        return False


class _Call(list):
    """The spans of one top-level call, in the order they opened."""

    def __init__(self, ident: int, top: Span):
        super().__init__((top,))
        self.ident = ident


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, rows=None, length=None, words=None, chunks=None):
    """Context manager of one span named ``dr.<name>``: a :class:`Span`
    with tracing on, the shared null context (which yields None) with it
    off."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _NULL
    return Span(name, rows, length, words, chunks)


class _Device:
    """An event pair; its own host time counts in its span's ``tracer_ns``."""

    __slots__ = ("record", "owner")

    def __init__(self, name: str, owner: Span, t0: int):
        self.record = [name, torch.cuda.Event(enable_timing=True), None]
        self.owner = owner
        owner.events.append(self.record)
        owner.tracer_ns += time.perf_counter_ns() - t0

    def __enter__(self):
        t0 = time.perf_counter_ns()
        self.record[1].record()
        self.owner.tracer_ns += time.perf_counter_ns() - t0

    def __exit__(self, *exc) -> bool:
        t0 = time.perf_counter_ns()
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.record[2] = end
        self.owner.tracer_ns += time.perf_counter_ns() - t0
        return False


def device(name: str, where: torch.Tensor | None = None):
    """Context manager that times the device work queued inside it on the
    current stream with two CUDA events, attached to the innermost open
    span; the shared null context with tracing off, outside any span,
    during a CUDA graph capture, or where ``where``, a tensor the work
    reads, is not on a card. Use it around work on a card only, or pass
    ``where``."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _NULL
    t0 = time.perf_counter_ns()
    stack = _stack()
    if (not stack or (where is not None and not where.is_cuda)
            or torch.cuda.is_current_stream_capturing()):
        return _NULL
    return _Device(name, stack[-1], t0)


def _device_ms(record) -> float | None:
    """A device event's elapsed ms, resolved once (waits for its end)."""
    name, start, end = record
    if isinstance(end, float) or end is None:
        return end
    end.synchronize()
    record[2] = start.elapsed_time(end)
    record[1] = None
    return record[2]


def snapshot() -> dict:
    """The kept calls' spans, oldest first, with their device ms; the
    counters; the kernel launches by wrapper."""
    from .ops import _kernels

    spans = []
    for call in list(_ring):
        index = {id(s): i for i, s in enumerate(call)}
        for s in call:
            rec = {"name": s.name, "call": call.ident,
                   "parent": None if s.parent is None else index[id(s.parent)],
                   "start_ns": s.start, "end_ns": s.end,
                   "outer_start_ns": s.outer_start,
                   "outer_end_ns": s.outer_end, "tracer_ns": s.tracer_ns}
            for key in ("rows", "length", "words", "chunks"):
                value = getattr(s, key)
                if value is not None:
                    rec[key] = int(value)
            device_ms: dict[str, float] = {}
            for ev in s.events:
                ms = _device_ms(ev)
                if ms is not None:
                    device_ms[ev[0]] = device_ms.get(ev[0], 0.0) + ms
            rec["device_ms"] = device_ms
            spans.append(rec)
    rejoined = sum(int(c.item()) for c in _kernels.tiles_rejoined.values())
    if rejoined:
        counters["tiles_rejoined"] = rejoined
    else:
        counters.pop("tiles_rejoined", None)
    return {"spans": spans, "counters": dict(counters),
            "launches": dict(_kernels.launches)}


def clear() -> None:
    """Empty the ring and zero the counters, the device's too (not the
    launch counts: ``ops._kernels.reset_launches``)."""
    from .ops import _kernels

    _ring.clear()
    counters.clear()
    for counter in _kernels.tiles_rejoined.values():
        counter.zero_()


# --- reading a snapshot ---------------------------------------------------

#: the codec's top-level span and its op wrapper's, by op
ENTRY = {"encode": "dr.encode_segments", "decode": "dr.decode_segments"}
WRAPPER = {"encode": "dr.pack_encode", "decode": "dr.unpack_decode"}


def calls(snap: dict, top: str, rows: int | None = None) -> list[list[dict]]:
    """The spans of each kept call whose top-level span is named ``top``
    (and has ``rows`` rows, when given), one list a call, the top first."""
    by_call: dict[int, list[dict]] = {}
    for s in snap["spans"]:
        by_call.setdefault(s["call"], []).append(s)
    out = []
    for spans in by_call.values():
        head = spans[0]
        if (head["parent"] is None and head["name"] == top
                and (rows is None or head.get("rows") == rows)):
            out.append(spans)
    return out


def self_ns(spans: list[dict], i: int) -> int:
    """Span ``i``'s duration less the union of its children's outer
    intervals (which hold their own bookkeeping and profiler annotation)."""
    s = spans[i]
    kids = sorted((max(c.get("outer_start_ns", c["start_ns"]), s["start_ns"]),
                   min(c.get("outer_end_ns", c["end_ns"]), s["end_ns"]))
                  for c in spans if c["parent"] == i)
    covered, cur = 0, s["start_ns"]
    for a, b in kids:
        a = max(a, cur)
        if b > a:
            covered += b - a
            cur = b
    return s["end_ns"] - s["start_ns"] - covered


def host_ns(span: dict) -> int:
    """A span's duration less the tracer's own time inside it."""
    return span["end_ns"] - span["start_ns"] - span.get("tracer_ns", 0)


def _median_ms(per_call_ns) -> float | None:
    per_call = list(per_call_ns)
    return statistics.median(per_call) * 1e-6 if per_call else None


def self_ms(snap: dict, top: str, rows: int) -> float | None:
    """Median over the kept ``top`` calls of ``rows`` rows of the top
    span's :func:`self_ns`, in ms; None without such a call."""
    return _median_ms(self_ns(c, 0) for c in calls(snap, top, rows))


def host_ms(snap: dict, top: str, rows: int, name: str) -> float | None:
    """Median over the kept ``top`` calls of ``rows`` rows that hold a
    span ``name`` of those spans' :func:`host_ns`, in ms; None without
    such a call."""
    return _median_ms(sum(host_ns(s) for s in c if s["name"] == name)
                      for c in calls(snap, top, rows)
                      if any(s["name"] == name for s in c))


def event_ms(snap: dict, top: str, rows: int, event: str) -> float | None:
    """Median over the kept ``top`` calls of ``rows`` rows that recorded
    the device event ``event`` of its device ms; None without such a call
    (on a CPU, where none is recorded)."""
    per_call = [sum(s["device_ms"][event] for s in c
                    if event in s["device_ms"])
                for c in calls(snap, top, rows)
                if any(event in s["device_ms"] for s in c)]
    return statistics.median(per_call) if per_call else None
