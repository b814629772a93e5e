"""Filters and inputs for the generic pre-filter inverse, shared by the CPU
tests of its plain version (``tests/test_torch_prefilter.py``, against the
JAX package) and the card tests of its kernel (``tests/test_torch_cuda.py``,
against the plain version). Imports no JAX.

The grid crosses every filter length from 1 to 12 taps (the kernel keeps
the history of filters up to 9 taps in registers, of longer ones in shared
memory) with leading taps that invert exactly (1, -1), divide (2, 8, -3,
-32768) and wrap mod 2**16 (65535 is -1). The other taps are seeded, some
past the int16 range so that they wrap too. The data puts 32767, -32767 and -32768 among
uniform int16 samples.

The blocked grid (the blocked scan of lossless filters of up to 8 history
taps, ``ops/prefilter_model.py`` on the CPU and the kernel on the card)
crosses six such filters with block lengths 8, 96 and 256, rows shorter
than a block, of one block, of three and of three plus one sample, and 1
and 33 rows.
"""

import numpy as np

F0S = (1, -1, 2, 8, -3, -32768, 65535)
NTAPS = tuple(range(1, 13))
GRID = [(n, f0) for n in NTAPS for f0 in F0S]  # (ntaps, f0) of each case
# the division's edges: a leading tap that wraps to 0 (-1 everywhere),
# -32768 / -1, the largest divisors, the codec's filters of the
# chip_smoke.py generic-filter phase
EDGES = ((65536, -1), (65536,), (-65536, 3, 1), (-1,), (-1, 1),
         (-32768, 5, -7), (65535, 3), (32767, -1), (1, -1, 0, 1),
         (1, 0, -1), (8, -1))


BLOCKED_FILTERS = ((1, -1, 0, 1), (1, 0, -1), (-1, 1), (1,),
                   (-1, 32767, -32768), (65535, 3, -7, 11, 2, -5, 9, 1, -3))
BLOCKS = (8, 96, 256)


def blocked_grid() -> list[tuple]:
    """(filter, block length, samples a row, rows) of each case."""
    return [(f, b, n, rows) for f in BLOCKED_FILTERS for b in BLOCKS
            for n in (b // 2 + 1, b, 3 * b, 3 * b + 1) for rows in (1, 33)]


def grid_filter(ntaps: int, f0: int) -> tuple[int, ...]:
    """``f0`` and ``ntaps - 1`` seeded taps in [-70000, 70000]."""
    rng = np.random.default_rng(1000 * ntaps + (f0 & 0xFFFF))
    return (f0,) + tuple(int(c) for c in rng.integers(-70000, 70001,
                                                      ntaps - 1))


def samples(shape, seed: int) -> np.ndarray:
    """Uniform int16 with the extremes strewn in."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-32768, 32768, shape).astype(np.int16)
    flat = x.reshape(-1)
    flat[::7] = 32767
    flat[3::11] = -32768
    flat[5::13] = -32767
    return x
