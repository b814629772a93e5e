"""Codec configuration: the filter's ``cd_values`` option schema.

The same schema as the reference filter's ``parseCD_VALUES``:

* 0 values: ``M=8``, ``waveform_length=-1`` (whole chunk is one segment),
  filter ``(1, -1)`` (delta encoding).
* 1 value:  ``(M,)``
* 2 values: ``(M, waveform_length)``
* >=3:      ``(M, waveform_length, filter_len, *filter)``

HDF5 stores the configuration in the dataset creation property list, so
files are self-describing; :meth:`RiceConfig.to_cd_values` /
:meth:`RiceConfig.from_cd_values` round-trip that encoding. The codec has no
other parameters, so a config built from another implementation's
cd_values is the whole state that carries across.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

DELTA_FILTER = (1, -1)

#: HDF5 filter ID shared with the reference implementation.
H5FILTER = 32025

#: Rice escape threshold: quotients >= this are stored verbatim as 16-bit
#: values after an 8-zeros+1 marker.
ESCAPE_Q = 8

#: Escape codeword length in bits: 8 zeros + terminating 1 + 16 raw bits.
ESCAPE_LEN = ESCAPE_Q + 1 + 16


def rice_k(m: int) -> int:
    """log2(M), validating M like the reference's ``determinePowerOf2``.

    Additionally requires ``M <= 2**15``: the reference encoder stores the
    remainder in a C ``short`` and silently corrupts the stream for larger M,
    so bigger values are rejected rather than reproduced.
    """
    if m <= 0:
        raise ValueError(f"Rice parameter M must be > 0, got {m}")
    if m & (m - 1):
        raise ValueError(f"Rice parameter M must be a power of 2, got {m}")
    if m > 1 << 15:
        raise ValueError(f"Rice parameter M must be <= 2**15, got {m}")
    return m.bit_length() - 1


def max_codeword_bits(m: int) -> int:
    """Tight upper bound on one codeword's bit length for Rice parameter M.

    Non-escape codewords are ``q + 1 + k`` bits with ``q < 8`` (or, for
    ``k >= 13``, ``q <= 65535 >> k``); escapes are 25 bits. Always <= 32.
    """
    k = rice_k(m)
    qmax = min(ESCAPE_Q - 1, 0xFFFF >> k)
    return max(qmax + 1 + k, ESCAPE_LEN if k < 13 else 0)


@dataclasses.dataclass(frozen=True)
class RiceConfig:
    """Delta-Rice codec parameters.

    ``waveform_length == -1`` means the whole chunk is a single segment.
    """

    m: int = 8
    waveform_length: int = -1
    filt: tuple[int, ...] = DELTA_FILTER

    def __post_init__(self):
        rice_k(self.m)
        if self.waveform_length == 0 or self.waveform_length < -1:
            raise ValueError(
                f"waveform_length must be positive or -1, got {self.waveform_length}"
            )
        filt = tuple(int(c) for c in self.filt)
        if not filt:
            raise ValueError("filter must be non-empty")
        if filt[0] == 0:
            raise ValueError("filter[0] must be non-zero (decode divides by it)")
        object.__setattr__(self, "filt", filt)

    @property
    def k(self) -> int:
        return rice_k(self.m)

    @property
    def is_delta(self) -> bool:
        """True for the fast-path delta filter (the reference's
        ``checkIfDeltaFilter``)."""
        return self.filt == DELTA_FILTER

    @property
    def lossless(self) -> bool:
        """The inverse pre-filter divides by ``filt[0]``; reconstruction is
        exact for all inputs only when that division is."""
        return abs(self.filt[0]) == 1

    def max_bits_per_sample(self) -> int:
        return max_codeword_bits(self.m)

    def max_words(self, n_samples: int) -> int:
        """Worst-case packed uint32 words for one segment of n samples."""
        return (n_samples * self.max_bits_per_sample() + 31) // 32

    def segments(self, total_samples: int) -> tuple[int, int, int]:
        """(num_segments, segment_length, leftover) for a chunk, matching
        the reference's ``writeWholeCompressedByteString``."""
        length = self.waveform_length
        if length == -1:
            length = total_samples
        n = total_samples // length if length else 0
        leftover = total_samples - n * length
        if leftover:
            n += 1
        return n, length, leftover

    def to_cd_values(self) -> tuple[int, ...]:
        if self.is_delta:
            if self.waveform_length == -1:
                return () if self.m == 8 else (self.m,)
            return (self.m, self.waveform_length)
        # cd_values are uint32 on the wire; -1 (whole-chunk) wraps to
        # 0xFFFFFFFF exactly as the reference stores it
        length = self.waveform_length & 0xFFFFFFFF
        return (self.m, length, len(self.filt)) + tuple(
            c & 0xFFFFFFFF for c in self.filt
        )

    @classmethod
    def from_cd_values(cls, cd_values: Sequence[int]) -> "RiceConfig":
        cd = [int(v) for v in cd_values]
        if len(cd) == 0:
            return cls()
        if len(cd) == 1:
            return cls(m=_as_i32(cd[0]))
        if len(cd) == 2:
            return cls(m=_as_i32(cd[0]), waveform_length=_as_i32(cd[1]))
        filt_len = _as_i32(cd[2])
        if filt_len <= 0 or len(cd) < 3 + filt_len:
            raise ValueError(f"invalid filter spec in cd_values: {cd}")
        filt = tuple(_as_i32(v) for v in cd[3 : 3 + filt_len])
        return cls(m=_as_i32(cd[0]), waveform_length=_as_i32(cd[1]), filt=filt)


def _as_i32(v: int) -> int:
    """cd_values are stored as unsigned 32-bit; the reference casts to int."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v
