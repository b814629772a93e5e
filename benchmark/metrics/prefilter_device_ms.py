"""prefilter_device_ms.<op>: device milliseconds of the generic pre-filter,
the forward FIR's torch passes before an encode's library call or the
inverse's kernels (``csrc/prefilter.cu``) after a decode's, from the CUDA
event pair ``prefilter`` / ``prefilter_inverse`` that the program records
around it on its stream, the median over the traced run's calls of the
cell's own row count. Read from the program's tracer; None without it, on
a CPU, where no event is recorded, and where no call recorded the pair:
the delta filter, which B1 and B2 fuse, or a program without the pair."""

#: the program's event pair, by op
EVENT = {"encode": "prefilter", "decode": "prefilter_inverse"}


def read(ctx, op):
    if ctx["op"] != op:
        return None
    try:
        from deltarice_tpu_torch import tracing
    except ImportError:  # a program without the tracer
        return None
    return tracing.event_ms(tracing.snapshot(), tracing.ENTRY[op], ctx["rows"],
                            EVENT[op])
