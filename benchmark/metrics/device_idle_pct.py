"""device_idle_pct.<op>: percent of the traced stretch in which no kernel,
memset or copy ran on the card: one less the union of the device's
intervals in the profiler's timeline over the stretch's length."""


def read(ctx, op):
    tr = ctx["trace"]
    if ctx["op"] != op or tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
