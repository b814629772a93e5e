"""pack_roofline: percent of the HBM bandwidth bound that the encode's
device work reaches over the traced calls. Bytes: the problem's (samples
read, stream words and counts written, from the reference's counts);
time: every kernel and memset the calls ran, by the profiler."""

from drbench import roofline


def read(ctx, _part=None):
    tr = ctx["trace"]
    if ctx["op"] != "encode" or tr is None:
        return None
    nbytes = roofline.encode_bytes(ctx["rows"] * ctx["traced_calls"],
                                   ctx["length"], ctx["traced_stream_words"])
    return roofline.share_pct(nbytes, tr.kernel_s)
