"""The one traffic generator: resident batches made from the seed, a
closed loop of codec calls with a fixed number of batches in flight, and
the records the metrics and the check read. A traffic file names its
``op`` and sets its numbers; a configuration file sets the sizes and the
codec's settings, in the order of the reference filter's ``cd_values``
``(M, L, n, *filter)``: ``rice_m`` (M), ``waveform_length`` (L) and
``filter``, any lossless causal integer pre-filter, a list of int32 taps
with ``|filter[0]| == 1`` (``[1, -1]`` is the delta filter). A filter
whose leading tap is not +-1 has no exact inverse, and the decode check
compares with the original samples: it is refused at set-up.

A batch's latency runs from its issue on the host clock until the host
sees its completion event, and includes what the host must still do for
it (an encode's over-cap rows encoded again at the full width).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import numpy as np
import torch

from . import data, reference

#: the program's pad-word bucket: decode planes are this many words wide
#: times a whole number, with one zero pad word at least
WORD_BUCKET = 256


@dataclasses.dataclass
class Call:
    index: int
    buffer: int
    issued: float
    enqueue_s: float
    phase: str
    event: object = None
    out: tuple = ()
    host_counts: object = None


@dataclasses.dataclass
class Records:
    enqueue_s: list = dataclasses.field(default_factory=list)
    latency_s: list = dataclasses.field(default_factory=list)
    latency_call: list = dataclasses.field(default_factory=list)
    kept: list = dataclasses.field(default_factory=list)  # (buffer, out)
    traced_buffers: list = dataclasses.field(default_factory=list)
    calls: int = 0


class Device:
    """CUDA events, pinned memory and synchronisation on a card; their
    plain stand-ins on the CPU (tests run the loop there)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"

    def event(self):
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def wait(self, ev) -> None:
        if ev is not None:
            ev.synchronize()

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def host(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=self.cuda)


def words_hint(x: torch.Tensor, m: int, length: int,
               filt=reference.DELTA) -> int:
    """A frozen copy of the arithmetic of the port's ``codec._words_hint``:
    the encode's word cap, from the largest per-row rate of a subsample of
    64 rows' first 4096 samples, pre-filtered by ``filt`` through the
    reference, plus 20 % and 64 words, in buckets of 256, never above the
    worst case. For the delta filter it is the program's cap; for any other
    filter the program takes the worst case, and this is the cap that a
    caller sizing from its own data would pass."""
    k = reference.rice_k(m)
    full = reference.max_words(length, m)
    if x.shape[1] < 64:
        return full
    rows = x[:: max(1, x.shape[0] // 64)][:64]
    d = reference.prefilter(rows[:, : min(rows.shape[1], 4096)], filt)
    u = (d << 1) ^ (d >> 63)
    q = u >> k
    bits = q.clamp(max=8) + 1 + k + torch.where(q >= 8, 16 - k, 0)
    bps = bits.to(torch.float64).mean(dim=1)
    est = float(bps.max()) * 1.2 * length / 32.0 + 64.0
    cap = -(-int(est) // WORD_BUCKET) * WORD_BUCKET
    return min(cap, full)


class Workload:
    """One cell's resident batches and its codec call."""

    def __init__(self, program, config: dict, traffic: dict, seed: int,
                 device, tracing: bool = False):
        self.prog = program
        self.dev = Device(device)
        self.where = str(self.dev.device)  # the entry points' ``device``
        self.op = traffic["op"]
        if self.op not in ("encode", "decode"):
            raise ValueError(f"unknown traffic op {self.op!r}")
        self.rows = config["chunk_rows"] * config["chunks_per_batch"]
        self.length = config["waveform_length"]
        self.m = config["rice_m"]
        self.filt = tuple(int(c) for c in config["filter"])
        if not self.filt or abs(self.filt[0]) != 1:
            raise ValueError(f"filter {list(self.filt)} is lossy: the "
                             f"benchmark takes |filter[0]| == 1 only")
        self.cfg = program.RiceConfig(self.m, self.length, filt=self.filt)
        self.in_flight = int(traffic["in_flight"])
        self.tracing = tracing
        self.reencoded = 0  # rows encoded again at the full width
        self.phase = "window"
        dev = self.dev.device
        self.x = [data.synthetic(self.rows, self.length, config["noise_sigma"],
                                 _stream(seed, b), dev)
                  for b in range(int(traffic["buffers"]))]
        self.nvalid = torch.full((self.rows,), self.length, dtype=torch.int32,
                                 device=dev)
        ring = self.in_flight + 1
        if self.op == "encode":
            self.cap = words_hint(self.x[0], self.m, self.length,
                                  filt=self.filt)
            self.full = self.cfg.max_words(self.length)
            self.counts_host = [self.dev.host((self.rows,), torch.int32)
                                for _ in range(ring)]
        else:
            # the plane the traffic reads, from the reference encoder, as
            # wide as the configuration states: the same work for every seed
            width = int(config["plane_words"])
            self.planes, self.ref_counts = [], []
            for b, xb in enumerate(self.x):
                nw = reference.counts_blocks(xb, self.nvalid, self.m,
                                             self.filt)
                if int(nw.max()) + 1 > width:
                    raise ValueError(
                        f"a stream of {int(nw.max())} words (seed {seed}, "
                        f"batch {b}) leaves no pad word in the configuration's "
                        f"plane of {width}")
                self.planes.append(reference.encode_blocks(
                    xb, self.nvalid, self.m, width, self.filt)[0])
                self.ref_counts.append(nw)

    @property
    def batch_bytes(self) -> int:
        return 2 * self.rows * self.length

    def span(self, name: str):
        if not self.tracing or self.phase != "trace":
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"bench.{name}")

    def issue(self, index: int) -> Call:
        b = index % len(self.x)
        t = time.perf_counter()
        with self.span("issue"):
            if self.op == "encode":
                out = self.prog.encode_segments(self.x[b], self.nvalid, self.cfg,
                                                self.cap, device=self.where)
            else:
                out = (self.prog.decode_segments(self.planes[b], self.length,
                                                 self.cfg, device=self.where),)
        enq = time.perf_counter() - t
        call = Call(index, b, t, enq, self.phase, out=out)
        with self.span("post"):
            if self.op == "encode":
                call.host_counts = self.counts_host[index % len(self.counts_host)]
                call.host_counts.copy_(out[1], non_blocking=True)
            call.event = self.dev.event()
        return call

    def complete(self, call: Call) -> Call:
        with self.span("wait"):
            self.dev.wait(call.event)
        if self.op == "encode":
            over = np.nonzero(call.host_counts.numpy() > self.cap)[0]
            if over.size:
                with self.span("reencode"):
                    idx = torch.from_numpy(over).to(self.dev.device)
                    again = self.prog.encode_segments(
                        self.x[call.buffer][idx], self.nvalid[idx], self.cfg,
                        self.full, device=self.where)
                    self.dev.wait(self.dev.event())
                call.out = (*call.out, idx, *again)
                self.reencoded += over.size
        return call

    def warm(self, hold: int = 0) -> float:
        """Runs every buffer through the loop's own calls, and an encode's
        full-width re-encode; returns the seconds a batch took. Then holds
        the outputs of ``hold`` calls and of a full ring at once, so that the
        caching allocator keeps a block for each output that the window
        keeps alive for the check, and the window allocates no new memory."""
        if self.op == "encode":
            idx = torch.arange(2, device=self.dev.device)
            self.prog.encode_segments(self.x[0][idx], self.nvalid[idx],
                                      self.cfg, self.full, device=self.where)
        for _ in range(2):
            self.dev.sync()
            t = time.perf_counter()
            for b in range(len(self.x)):
                self.complete(self.issue(b))
            self.dev.sync()
        per_batch = (time.perf_counter() - t) / len(self.x)
        held = [self.complete(self.issue(i))
                for i in range(hold + self.in_flight + 1)]
        self.dev.sync()
        del held
        self.reencoded = 0
        return per_batch


def _stream(seed: int, buffer: int) -> int:
    """Generator seed of one buffer: distinct for each buffer of a seed."""
    return (int(seed) * 1000003 + buffer) % (1 << 63)


def window(work: Workload, seconds: float, rec: Records,
           keep: set | None = None) -> float:
    """Issue calls for ``seconds`` with ``work.in_flight`` in flight, then
    drain; returns the wall seconds up to the device's last completion."""
    pending = collections.deque()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        pending.append(work.issue(rec.calls))
        rec.calls += 1
        if len(pending) >= work.in_flight:
            _done(work, pending.popleft(), rec, keep)
    while pending:
        _done(work, pending.popleft(), rec, keep)
    work.dev.sync()
    return time.perf_counter() - t0


def _done(work: Workload, call: Call, rec: Records, keep) -> None:
    work.complete(call)
    if call.phase == "window":
        rec.latency_s.append(time.perf_counter() - call.issued)
        rec.latency_call.append(call.index)
        rec.enqueue_s.append(call.enqueue_s)
    elif call.phase == "trace":
        rec.traced_buffers.append(call.buffer)
    if keep is not None and call.index in keep:
        rec.kept.append((call.buffer, call.out))
