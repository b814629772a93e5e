"""Reduction of a ``torch.profiler`` trace of one stretch of the window to
what the per-layer metrics and the breakdown read: the stretch's length,
the union of the device's busy intervals, device time by operation, and
the idle gaps labelled by what the host was doing.

The stretch is the host span ``bench.window``; the host spans
``bench.<what>`` that the traffic opens around its steps label the gaps.
"""

from __future__ import annotations

import dataclasses

WINDOW = "bench.window"
SPAN_PREFIX = "bench."


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    device_ops: dict[str, float]  # seconds by operation name
    kernel_s: float               # kernels and memsets, copies left out
    gaps: list[tuple[str, float]]  # (host span, seconds), longest first


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy")


def summarize(device: list[tuple[str, int, int]],
              host: list[tuple[str, int, int]]) -> Summary | None:
    """``device``: (name, start_ns, end_ns) of every operation that ran on
    the device; ``host``: the same of the host spans. None without a
    window span or without any device operation inside it."""
    windows = [(s, e) for n, s, e in host if n == WINDOW]
    if not windows:
        return None
    ws, we = windows[0]
    inside = [(n, max(s, ws), min(e, we)) for n, s, e in device
              if e > ws and s < we]
    if not inside:
        return None
    ops: dict[str, float] = {}
    kernel_ns = 0
    for n, s, e in inside:
        ops[n] = ops.get(n, 0.0) + (e - s) * 1e-9
        if not is_copy(n):
            kernel_ns += e - s
    busy, gaps = _union(sorted((s, e) for _, s, e in inside), ws, we)
    spans = [(n[len(SPAN_PREFIX):], s, e) for n, s, e in host
             if n.startswith(SPAN_PREFIX) and n != WINDOW]
    labelled = sorted(((_label(g, spans), (g[1] - g[0]) * 1e-9) for g in gaps),
                      key=lambda t: -t[1])
    return Summary(window_s=(we - ws) * 1e-9, busy_s=busy * 1e-9,
                   device_ops=ops, kernel_s=kernel_ns * 1e-9, gaps=labelled)


def _union(intervals, ws: int, we: int):
    """(busy ns of the union of sorted intervals, the gaps between them in
    [ws, we])."""
    busy, gaps, cur = 0, [], ws
    run_s = run_e = None
    for s, e in intervals:
        if run_e is not None and s <= run_e:
            run_e = max(run_e, e)
            continue
        if run_e is not None:
            busy += run_e - run_s
            cur = run_e
        if s > cur:
            gaps.append((cur, s))
        run_s, run_e = s, e
    if run_e is not None:
        busy += run_e - run_s
        cur = run_e
    if we > cur:
        gaps.append((cur, we))
    return busy, gaps


def _label(gap, spans) -> str:
    """The host span that overlaps the gap the most ("host" for none)."""
    best, most = "host", 0
    for n, s, e in spans:
        ov = min(e, gap[1]) - max(s, gap[0])
        if ov > most:
            best, most = n, ov
    return best


def from_profiler(prof) -> Summary | None:
    """:func:`summarize` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        item = (ev.name(), ev.start_ns(), ev.end_ns())
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():
                device.append(item)
        elif ev.name().startswith(SPAN_PREFIX):
            host.append(item)
    return summarize(device, host)


def breakdown(summary: Summary, top: int = 10) -> dict:
    ops = sorted(summary.device_ops.items(), key=lambda t: -t[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in summary.gaps[:top]]}
