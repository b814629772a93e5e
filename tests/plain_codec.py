"""A plain Delta-Rice codec for the tests: plain torch and numpy, written
from the format alone, the way the benchmark's own copy
(``benchmark/drbench/reference.py``) is. It imports neither
``deltarice_tpu`` nor ``deltarice_tpu_torch``, so a test that holds the
port to it holds the port to the format and not to either package.

Format (the reference filter's, HDF5 filter 32025, ``cd_values``
``(M, L, n, *filter)``):

* pre-filter, a causal integer FIR ``d[n] = sum_j x[n-j] * filt[j]`` with
  ``x[n] = 0`` before a segment's first sample, wrapped to int16 (the
  reference accumulates in a C ``short``; wrapping mod 2**16 commutes with
  sums and products, so one wrap of the int64 sum is the same). Its
  inverse, ``x[n] = (d[n] - sum_{j>=1} x[n-j] * filt[j]) / filt[0]`` on the
  wrapped numerator, is exact for ``|filt[0]| == 1``;
* zigzag: ``u = 2d`` for ``d >= 0``, ``u = -2d - 1`` for ``d < 0``;
* Rice code with ``M = 2**k``: ``q = u >> k``; below 8, ``q`` zeros, a one
  and the ``k`` low bits of ``u``; from 8 on, the escape: 8 zeros, a one
  and ``u`` in 16 bits (25 bits);
* codewords laid end to end MSB-first in uint32 words, one stream a
  segment, its last word zero-filled at the low end;
* a chunk's frame: ``u32 total`` then ``u32 nwords, words`` a segment,
  ``ceil(total / L)`` segments (``L == -1``: one), the last holding the
  leftover samples.

Departures from the C reference: none. The encoder works on whole rows
at once and the decoder walks all rows in step, where the C code walks
one segment at a time; the bits are the same (the tests hold this file to
the C reference's committed golden streams).
"""

from __future__ import annotations

import numpy as np
import torch

ESCAPE_Q = 8
ESCAPE_LEN = ESCAPE_Q + 1 + 16
DELTA = (1, -1)


def rice_k(m: int) -> int:
    if m <= 0 or m & (m - 1) or m > 1 << 15:
        raise ValueError(f"M must be a power of two up to 2**15, got {m}")
    return m.bit_length() - 1


def max_words(length: int, m: int) -> int:
    """Words of the longest stream ``length`` samples can make: every
    codeword at its longest (an escape, or below 8 the longest plain one)."""
    k = rice_k(m)
    qmax = min(ESCAPE_Q - 1, 0xFFFF >> k)
    return (length * max(qmax + 1 + k, ESCAPE_LEN if k < 13 else 0) + 31) // 32


def wrap16(v):
    """``v`` (int64) wrapped into the int16 range, kept as int64."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def prefilter(x: torch.Tensor, filt=DELTA) -> torch.Tensor:
    """The pre-filtered rows of ``x`` ((rows, L)), each row from zero
    history, wrapped to int16 and kept as int64."""
    xi = x.to(torch.int64)
    d = xi * int(filt[0])
    for j, c in enumerate(filt[1:], start=1):
        if c and j < x.shape[1]:
            d[:, j:].add_(xi[:, :-j], alpha=int(c))
    return wrap16(d)


def codewords(x: torch.Tensor, nvalid: torch.Tensor, m: int, filt=DELTA):
    """Per-sample (bit length, right-aligned bits), both int64, of the
    pre-filtered rows of ``x`` (int16, (rows, L)); samples at or past a
    row's ``nvalid`` get length 0."""
    k = rice_k(m)
    d = prefilter(x, filt)
    u = torch.where(d >= 0, 2 * d, -2 * d - 1)
    q = u >> k
    esc = q >= ESCAPE_Q
    length = torch.where(esc, ESCAPE_LEN, q + 1 + k)
    bits = torch.where(esc, (1 << 16) | u, (1 << k) | (u & ((1 << k) - 1)))
    pos = torch.arange(x.shape[1], device=x.device)
    length = torch.where(pos[None, :] < nvalid.to(x.device, torch.int64)[:, None],
                         length, 0)
    return length, bits


def encode(x: torch.Tensor, nvalid: torch.Tensor, m: int, width: int,
           filt=DELTA):
    """Encode each row into ``width`` words: (words (rows, width) int32
    holding the uint32 bit patterns, zero past each stream; nwords (rows,)
    int64, exact even where a stream is wider than ``width``)."""
    length, bits = codewords(x, nvalid, m, filt)
    end = torch.cumsum(length, dim=1)
    start = end - length
    nwords = (end[:, -1] + 31) // 32 if x.shape[1] else torch.zeros_like(end[:, 0])
    first = start >> 5
    spill = (start & 31) + length - 32  # > 0: the codeword runs into the next word
    head = torch.where(spill > 0, bits >> spill.clamp(min=0),
                       bits << (-spill).clamp(min=0))
    tail = torch.where(spill > 0, (bits << (32 - spill).clamp(min=0)) & 0xFFFFFFFF, 0)
    head = torch.where(length > 0, head, 0)
    # codewords share no bit, so adding their parts is OR-ing them; one
    # extra column takes whatever lies past ``width``
    out = torch.zeros(x.shape[0], width + 1, dtype=torch.int64, device=x.device)
    out.scatter_add_(1, first.clamp(max=width), head)
    out.scatter_add_(1, (first + 1).clamp(max=width), tail)
    out = out[:, :width]
    out = torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)
    return out, nwords


def decode(words: np.ndarray, n_samples: int, m: int,
           filt=DELTA) -> np.ndarray:
    """Serial decode of each row's stream (uint32 (rows, W)) into
    ``n_samples`` int16 samples: a bit cursor walked one codeword at a
    time, the rows in step, and the pre-filter inverted sample by sample.
    Lossless filters only."""
    k = rice_k(m)
    f0 = int(filt[0])
    if abs(f0) != 1:
        raise ValueError(f"filter {tuple(filt)} has no exact inverse: "
                         f"|filt[0]| must be 1")
    rev = np.array([int(c) for c in filt[:0:-1]], np.int64)  # c_nh .. c_1
    nh = rev.size
    w = np.asarray(words, dtype=np.uint64)
    rows = w.shape[0]
    # a 64-bit window from the cursor's word on; zero words past the end
    w = np.concatenate([w, np.zeros((rows, 2), np.uint64)], axis=1)
    r = np.arange(rows)
    last = w.shape[1] - 2
    bit = np.zeros(rows, np.int64)
    out = np.zeros((rows, nh + n_samples), np.int64)  # sample i at nh + i
    for i in range(n_samples):
        wi = np.minimum(bit >> 5, last)  # past the stream: zeros
        win = ((w[r, wi] << np.uint64(32)) | w[r, wi + 1]) << (bit & 31).astype(np.uint64)
        win = (win >> np.uint64(32)) & np.uint64(0xFFFFFFFF)  # next 32 bits
        q = _leading_zeros(win)
        esc = q >= ESCAPE_Q
        u_esc = (win >> np.uint64(32 - ESCAPE_LEN)) & np.uint64(0xFFFF)
        shift = np.maximum(31 - k - q, 0).astype(np.uint64)
        u_rice = (q << k) | ((win >> shift) & np.uint64((1 << k) - 1)).astype(np.int64)
        u = np.where(esc, u_esc.astype(np.int64), u_rice)
        d = np.where(u & 1, -((u + 1) >> 1), u >> 1)
        num = wrap16(d - out[:, i:i + nh] @ rev)
        out[:, nh + i] = wrap16(num * f0)
        bit += np.where(esc, ESCAPE_LEN, q + 1 + k)
    return out[:, nh:].astype(np.int16)


def _leading_zeros(win: np.ndarray) -> np.ndarray:
    """Leading zeros of 32-bit values, capped at ``ESCAPE_Q``."""
    q = np.full(win.shape, ESCAPE_Q, np.int64)
    for z in range(ESCAPE_Q - 1, -1, -1):
        q = np.where((win >> np.uint64(31 - z)) & np.uint64(1) == 1, z, q)
    return q


def _segments(total: int, waveform_length: int):
    """(segments, samples a segment, valid samples of each) of a chunk."""
    length = total if waveform_length == -1 else waveform_length
    nseg = -(-total // length) if total else 0
    nvalid = np.full(nseg, length, np.int64)
    if nseg and total % length:
        nvalid[-1] = total % length
    return nseg, length, nvalid


def frame(chunk: np.ndarray, m: int, waveform_length: int,
          filt=DELTA) -> bytes:
    """The framed stream of one chunk (1-D int16), as the reference filter
    writes it."""
    total = chunk.shape[0]
    nseg, length, nvalid = _segments(total, waveform_length)
    rows = np.zeros((nseg, length), np.int16)
    rows.reshape(-1)[:total] = chunk
    x, nv = torch.from_numpy(rows), torch.from_numpy(nvalid)
    width = max_words(length, m)
    words, nwords = encode(x, nv, m, width, filt)
    out = [np.array([total], "<u4")]
    for s in range(nseg):
        out.append(np.array([int(nwords[s])], "<u4"))
        out.append(words[s, : int(nwords[s])].numpy().view(np.uint32).astype("<u4"))
    return b"".join(a.tobytes() for a in out)


def unframe(blob: bytes, m: int, waveform_length: int,
            filt=DELTA) -> np.ndarray:
    """The chunk (1-D int16) that a framed stream holds."""
    buf = np.frombuffer(blob, "<u4")
    total = int(buf[0])
    nseg, length, nvalid = _segments(total, waveform_length)
    streams, at = [], 1
    for _ in range(nseg):
        n = int(buf[at])
        streams.append(buf[at + 1: at + 1 + n])
        at += 1 + n
    if at != buf.size:
        raise ValueError(f"{4 * (buf.size - at)} bytes past the last segment")
    plane = np.zeros((nseg, max((s.size for s in streams), default=0)), np.uint32)
    for s, words in enumerate(streams):
        plane[s, : words.size] = words
    rows = decode(plane, length, m, filt)
    return np.concatenate([rows[s, : nvalid[s]] for s in range(nseg)]
                          or [np.zeros(0, np.int16)])
