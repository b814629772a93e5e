"""enqueue_ms.<op>: host milliseconds from a call of the codec's entry
point to its return, the median over the window's calls (the traced
stretch left out), from the benchmark's own clock around each call."""

import statistics


def read(ctx, op):
    if ctx["op"] != op or not ctx["enqueue_s"]:
        return None
    return 1e3 * statistics.median(ctx["enqueue_s"])
