"""prefilter_roofline.<op>: percent of the HBM bandwidth bound that the
generic pre-filter reaches in one call. Bytes: the filter's own problem,
each int16 sample read once and written once, the same for any
implementation of it; time: ``prefilter_device_ms`` of the same op. None
where that reads None."""

from drbench import spec
from drbench.roofline import share_pct


def prefilter_bytes(rows: int, length: int) -> int:
    """The int16 samples read and the int16 filtered samples written."""
    return 4 * rows * length


def read(ctx, op):
    ms = spec.reader(f"prefilter_device_ms.{op}")(ctx)
    if ms is None:
        return None
    return share_pct(prefilter_bytes(ctx["rows"], ctx["length"]), ms * 1e-3)
