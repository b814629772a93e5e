"""The bytes a codec call must move, counted from the problem, and the
card's peak. What an implementation also writes (the zeroed width of its
word plane, its scratch, re-encodes, and the passes of a pre-filter other
than the delta: its forward filter before the encode, its inverse after
the decode) is its own: it counts in the time and never in these bytes,
which are the same for every filter."""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s, at the full
#: power limit of 700 W (the run prints the card's own limit beside it)
HBM_BYTES_PER_S = 3.35e12


def encode_bytes(rows: int, length: int, stream_words: int) -> int:
    """Encode: the int16 samples read, the stream words written and one
    4-byte count a row written."""
    return 2 * rows * length + 4 * stream_words + 4 * rows


def decode_bytes(rows: int, length: int, stream_words: int) -> int:
    """Decode: the stream words read and the int16 samples written."""
    return 4 * stream_words + 2 * rows * length


def share_pct(nbytes: int, seconds: float) -> float | None:
    """Percent of the bandwidth bound that ``nbytes`` in ``seconds`` of
    device time reach; None where no device time was read."""
    if seconds <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
