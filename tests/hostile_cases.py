"""Corrupt and hostile framed streams, shared by the CPU tests of the port
against the JAX package (``tests/test_torch_robustness.py``), the card
tests (``tests/test_torch_cuda.py``) and ``chip_smoke.py``'s hostile
phase, which imports this file by path. Imports numpy only.

Every case starts from a stream a correct encoder wrote and damages it in
one way. A decoder must raise ``ValueError`` or return garbage of the
stream's length; it must never crash, hang or read out of bounds. The
cases, each made from a numpy seed:

(a) truncations: a cut at every ``stride``-th byte, one word short, one
    byte short;
(b) single-bit flips: ``n`` flips of seed 2 over the header and payload
    words (the total word left alone), each undone before the next;
(c) lying totals: a total of 10**6 samples, and a total of 0 with words
    after it;
(d) the empty stream;
(e) one segment credited with every payload word: segment 0's count
    covers all the words after it, the other segments' counts are 0 at
    the end, so the header walk stays consistent and the decode bucket
    widens to the whole stream;
(f) bad payloads behind valid headers: every payload word random, zero
    or all ones.

The generic-filter and long-segment cases, (g) and (h), are the flips of
(b) over streams of :data:`GENERIC_FILTERS` and of long segments; their
tests build those streams and call :func:`flips`.
"""

import numpy as np

FLIP_SEED = 2
#: the optimizer's lossless (1, 0, -1), whose inverse takes the blocked
#: scan, and the lossy (8, -1), whose inverse takes the serial walk
GENERIC_FILTERS = ((1, 0, -1), (8, -1))


def walk(blob: bytes, nseg: int):
    """(counts, starts) of the stream's segments by the codecs' header walk
    (words may remain after the last segment); ``ValueError`` where the
    walk runs past the stream."""
    buf = np.frombuffer(blob, dtype="<u4")
    counts = np.empty(nseg, np.int64)
    starts = np.empty(nseg, np.int64)
    pos = 1
    for i in range(nseg):
        if pos >= buf.size:
            raise ValueError("truncated Delta-Rice stream")
        starts[i] = pos
        counts[i] = int(buf[pos])
        pos += int(buf[pos]) + 1
    if pos > buf.size:
        raise ValueError("truncated Delta-Rice stream")
    return counts, starts


def batchable(streams, nseg: int, total: int):
    """The streams that keep ``total`` and pass the header walk: those a
    batch decode can take together (one stream that fails the walk fails
    its whole batch)."""
    out = []
    for s in streams:
        if len(s) < 4 or len(s) % 4 or int(
                np.frombuffer(s[:4], dtype="<u4")[0]) != total:
            continue
        try:
            walk(s, nseg)
        except ValueError:
            continue
        out.append(s)
    return out


def faulty_frames(calls, real, fault: str = "payload"):
    """Wrap an encoder's ``frame_stream`` for fault injection: on the
    numbered calls (from 0) flip a payload bit, keeping the headers, or
    with ``fault="header"`` cut the stream to 6 bytes, so the header walk
    raises. ``wrapped.count[0]`` is the number of calls made."""
    count = [0]

    def wrapped(total, words, nwords):
        blob = real(total, words, nwords)
        n = count[0]
        count[0] += 1
        if n not in calls:
            return blob
        if fault == "header":
            return blob[:6]
        blob = bytearray(blob)
        blob[-1] ^= 0x40
        return bytes(blob)

    wrapped.count = count
    return wrapped


def truncations(blob: bytes, stride: int = 97):
    cuts = list(range(0, len(blob), stride)) + [len(blob) - 4, len(blob) - 1]
    return [(f"cut {c}", blob[:c]) for c in cuts]


def flips(blob: bytes, n: int = 300, seed: int = FLIP_SEED):
    rng = np.random.default_rng(seed)
    buf = bytearray(blob)
    out = []
    for _ in range(n):
        pos = int(rng.integers(4, len(buf)))
        bit = int(rng.integers(0, 8))
        buf[pos] ^= 1 << bit
        out.append((f"flip {pos}.{bit}", bytes(buf)))
        buf[pos] ^= 1 << bit
    return out


def lying_totals(blob: bytes):
    words = np.frombuffer(blob, dtype="<u4").copy()
    big = words.copy()
    big[0] = 10**6
    zero = words.copy()
    zero[0] = 0
    return [("total 10**6", big.tobytes()), ("total 0", zero.tobytes())]


def one_segment(blob: bytes, nseg: int):
    words = np.frombuffer(blob, dtype="<u4")
    body = words[2:]
    head = np.array([words[0], body.size], dtype="<u4")
    tail = np.zeros(nseg - 1, dtype="<u4")
    return [("one segment", np.concatenate([head, body, tail]).tobytes())]


def bad_payloads(blob: bytes, nseg: int, seed: int = FLIP_SEED):
    """Payload words random, zero and all ones; headers as written."""
    words = np.frombuffer(blob, dtype="<u4")
    _counts, starts = walk(blob, nseg)
    payload = np.ones(words.size, bool)
    payload[0] = False
    payload[starts] = False
    rng = np.random.default_rng(seed)
    out = []
    for name, fill in (("random", None), ("zeros", 0), ("ones", 0xFFFFFFFF)):
        w = words.copy()
        w[payload] = (rng.integers(0, 1 << 32, int(payload.sum()),
                                   dtype=np.uint64).astype(np.uint32)
                      if fill is None else fill)
        out.append((f"payload {name}", w.tobytes()))
    return out


def corpus(blob: bytes, nseg: int, n_flips: int = 300, stride: int = 97,
           seed: int = FLIP_SEED):
    """Cases (a)-(f) of one valid stream of ``nseg`` segments, in order:
    [(name, stream bytes), ...]."""
    return (truncations(blob, stride) + flips(blob, n_flips, seed)
            + lying_totals(blob) + [("empty", b"")]
            + one_segment(blob, nseg) + bad_payloads(blob, nseg, seed))


def outcome(decode, stream):
    """("raised", None) where ``decode(stream)`` raises ``ValueError``,
    else ("returned", its int16 array); any other exception propagates."""
    try:
        return "returned", np.asarray(decode(stream))
    except ValueError:
        return "raised", None


def same(a, b) -> bool:
    """Two outcomes agree: both raised, or both returned equal arrays."""
    return a[0] == b[0] and (a[0] == "raised" or (
        a[1].dtype == b[1].dtype and np.array_equal(a[1], b[1])))
