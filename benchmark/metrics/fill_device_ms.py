"""fill_device_ms.encode: device milliseconds of the word plane's zero
fill before the encode's library call, from the CUDA event pair ``fill``
that the program records around it, the median over the traced run's
encodes of the cell's own row count. Read from the program's tracer; None
without it, for a decode, and on a CPU, where no event is recorded."""


def read(ctx, op):
    if ctx["op"] != op or op != "encode":
        return None
    try:
        from deltarice_tpu_torch import tracing
    except ImportError:  # a program without the tracer
        return None
    return tracing.event_ms(tracing.snapshot(), tracing.ENTRY[op], ctx["rows"],
                            "fill")
