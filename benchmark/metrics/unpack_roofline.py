"""unpack_roofline: percent of the HBM bandwidth bound that the decode's
device work reaches over the traced calls. Bytes: the problem's (stream
words read, from the reference's counts, and samples written); time:
every kernel and memset the calls ran, by the profiler."""

from drbench import roofline


def read(ctx, _part=None):
    tr = ctx["trace"]
    if ctx["op"] != "decode" or tr is None:
        return None
    nbytes = roofline.decode_bytes(ctx["rows"] * ctx["traced_calls"],
                                   ctx["length"], ctx["traced_stream_words"])
    return roofline.share_pct(nbytes, tr.kernel_s)
