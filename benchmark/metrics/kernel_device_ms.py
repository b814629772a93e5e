"""kernel_device_ms.<op>: device milliseconds of the codec's library call
(every pass and memset that ``dr_pack_encode`` / ``dr_unpack_decode``
launches), from the CUDA event pair ``kernels`` that the program records
around it on its stream, the median over the traced run's calls of the
cell's own row count. Read from the program's tracer; None without it and
on a CPU, where no event is recorded."""


def read(ctx, op):
    if ctx["op"] != op:
        return None
    try:
        from deltarice_tpu_torch import tracing
    except ImportError:  # a program without the tracer
        return None
    return tracing.event_ms(tracing.snapshot(), tracing.ENTRY[op], ctx["rows"],
                            "kernels")
