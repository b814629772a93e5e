"""Profiling helpers: the card's name and power limit, a ``torch.profiler``
device trace, throughput timed with CUDA events over windows of calls (the
median and spread of several windows), and device times of short kernels
from CUDA graphs, warm or over rotated buffers."""

from __future__ import annotations

import collections
import contextlib
import statistics
import subprocess
import tempfile
import time

import torch


class NoCard(RuntimeError):
    """A CUDA device was asked for on a machine without a CUDA card."""


def card(device="cuda") -> str | None:
    """The card behind ``device`` as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives it (e.g.
    ``NVIDIA H100 80GB HBM3, 700.00 W``); None on a CPU device. Raises
    :class:`NoCard` for a CUDA device without a card and RuntimeError when
    nvidia-smi fails: no measurement falls back to the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    if not torch.cuda.is_available():
        raise NoCard(f"device {str(device)!r} needs a CUDA card and this "
                     f"machine has none; pass --device cpu for a run of the "
                     f"kernels' plain versions")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if smi.returncode != 0 or index >= len(lines):
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return lines[index].strip()


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace host and CUDA activity around a block with ``torch.profiler``
    and write a Chrome trace (``trace.json``, view in Perfetto or
    chrome://tracing) into ``logdir``. Yields the profiler, whose
    ``key_averages()`` give device time by kernel."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def device_rows(prof) -> list[tuple[float, int, str]]:
    """(device ms, count, name) of a profiler's kernel and memcpy rows,
    largest first; ``aten::`` and profiler-internal rows are left out."""
    rows = []
    for ev in prof.key_averages():
        ms = ev.device_time_total / 1e3
        if ms <= 0 or ev.key.startswith(("aten::", "Activity Buffer")):
            continue
        rows.append((ms, ev.count, ev.key))
    return sorted(rows, reverse=True)


def profiled(fn, tries: int = 3) -> tuple[list, float]:
    """(:func:`device_rows`, wall ms) of one ``torch.profiler`` repeat of
    ``fn()`` on the card, synchronised. A repeat whose trace kept no device
    row (late in a long process a trace can lose every launch) is taken
    again, up to ``tries`` times; the rows are empty when every try lost
    them."""
    for _ in range(tries):
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp, device_trace(tmp) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = device_rows(prof)
        if rows:
            break
    return rows, wall


def windows(fn, *args, iters: int = 20, reps: int = 5,
            device="cuda") -> list[float]:
    """Seconds per call of ``fn(*args)`` in each of ``reps`` windows of
    ``iters`` calls, after one warm-up call: two CUDA events on the current
    stream around each window, synchronised (the host clock on a CPU
    device)."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise NoCard("timing on a CUDA device needs a CUDA card")
        fn(*args)
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / 1e3 / iters)
        return out
    fn(*args)
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        out.append((time.perf_counter() - t0) / iters)
    return out


def spread(seconds: list[float], nbytes: int | None = None) -> dict:
    """The median and the range of per-call times from :func:`windows`, in
    milliseconds, and with ``nbytes`` as GB/s (the fastest window gives
    ``GBps_max``)."""
    med = statistics.median(seconds)
    out = {"ms": med * 1e3, "ms_min": min(seconds) * 1e3,
           "ms_max": max(seconds) * 1e3, "windows": len(seconds)}
    if nbytes is not None:
        out.update(GBps=nbytes / med / 1e9,
                   GBps_min=nbytes / max(seconds) / 1e9,
                   GBps_max=nbytes / min(seconds) / 1e9)
    return out


#: calls shorter than this (ms) are also timed in a CUDA graph by
#: :func:`timed`: a host loop would time the wrapper's host cost instead
SHORT_MS = 0.1


def timed(fn, nbytes: int | None = None, iters: int = 20, reps: int = 5,
          device="cuda", graph: bool = True) -> dict:
    """:func:`spread` of :func:`windows` of ``fn()``; with ``graph``, a call
    on a card under ``SHORT_MS`` also gets ``graph_ms`` (:func:`graph_ms`:
    device time alone). ``graph=False`` for calls that a capture refuses
    (pageable copies, pinned allocations)."""
    t = spread(windows(fn, iters=iters, reps=reps, device=device), nbytes)
    if graph and torch.device(device).type == "cuda" and t["ms"] < SHORT_MS:
        t["graph_ms"] = graph_ms([fn])
    return t


def throughput(fn, *args, nbytes: int, iters: int = 20,
               device="cuda") -> dict:
    """Throughput of ``fn(*args)``: one window of :func:`windows`. Returns
    {"seconds_per_call", "gbps"}."""
    dt = windows(fn, *args, iters=iters, reps=1, device=device)[0]
    return {"seconds_per_call": dt, "gbps": nbytes / max(dt, 1e-12) / 1e9}


def graph_ms(fns, reps: int = 20) -> float:
    """Mean milliseconds per call on the card's timeline of ``reps`` calls,
    call i being ``fns[i % len(fns)]()``, captured in one CUDA graph and
    replayed (after one warm-up call of each and one warm-up replay): no
    host time between launches, so a kernel shorter than its wrapper's
    host cost is timed all the same. The graph and its memory pool are
    released before it returns."""
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
        side.synchronize()
        with torch.cuda.graph(graph, stream=side):
            for i in range(reps):
                fns[i % len(fns)]()
    torch.cuda.synchronize()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / (5 * reps)


def rotated(fn, inputs) -> list:
    """Calls of ``fn`` over ``inputs`` in turn, each output kept until
    ``len(inputs) - 1`` later calls have run, so that consecutive calls
    also write to different buffers (a cold timing's rotation)."""
    kept = collections.deque(maxlen=len(inputs) - 1)
    return [lambda x=x: kept.append(fn(x)) for x in inputs]
