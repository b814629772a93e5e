"""entry_self_ms.<op>: host milliseconds that the codec's entry point
spends itself, outside its child spans: the program's top-level
``dr.encode_segments`` / ``dr.decode_segments`` span's duration less the
union of its children's intervals, the median over the traced run's calls
of the cell's own row count (the benchmark's re-encodes of rows past the
cap left out). Read from the program's tracer (``deltarice_tpu_torch.
tracing``), on while the profiler records; None without it."""


def read(ctx, op):
    if ctx["op"] != op:
        return None
    try:
        from deltarice_tpu_torch import tracing
    except ImportError:  # a program without the tracer
        return None
    return tracing.self_ms(tracing.snapshot(), tracing.ENTRY[op], ctx["rows"])
