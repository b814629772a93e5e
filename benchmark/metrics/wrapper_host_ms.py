"""wrapper_host_ms.<op>: host milliseconds of the op wrapper under the
codec's entry, ``dr.pack_encode`` / ``dr.unpack_decode`` (argument checks,
the output and scratch allocations, the word plane's fill queued, the
library call), less the tracer's own time inside it (its children's
bookkeeping and annotations, its CUDA event pairs), the median over the
traced run's calls of the cell's own row count. Read from the program's
tracer; None without it."""


def read(ctx, op):
    if ctx["op"] != op:
        return None
    try:
        from deltarice_tpu_torch import tracing
    except ImportError:  # a program without the tracer
        return None
    return tracing.host_ms(tracing.snapshot(), tracing.ENTRY[op], ctx["rows"],
                           tracing.WRAPPER[op])
