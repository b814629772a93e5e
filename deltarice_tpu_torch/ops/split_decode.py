"""Speculative split decode: intra-segment decode parallelism for batches of
few, long segments (the JAX package's answer to a decode with one lane per
segment) — the port of ``deltarice_tpu/ops/split_decode.py``. The port's
exact B2 is itself parallel inside each segment; this path stays behind
its switch.

Each segment's word stream is cut into P uniform word ranges that decode
in parallel warps (B9, :mod:`.split_decode_cuda`). A range p > 0 cannot
know the bit phase of its first codeword, so it starts ``halo`` words early
at phase 0 and rides Rice's self-synchronisation. The junction check
``entry_p == exit_{p-1}`` then proves, by induction from range 0's known
phase 0, that every range decoded from the true bit position (a decode is
a pure function of bits and start position); a mismatch flags the segment
for the caller's exact re-decode through B2. Sample counts and the delta
state chain through per-range scalars (exclusive prefix sums), and the
ragged ranges join in one B6 concentration.

Host logic (the router, halo and width rules) is the JAX package's, so
both packages split and flag identically.
"""

from __future__ import annotations

import numpy as np
import torch

from .concentrate_cuda import DEAD, biased_plane, concentrate_wide16
from .split_decode_cuda import codewords_per_word, split_decode

_SB = 8          # TPU sublanes: the router's lane target is _SB * _LANES
_LANES = 128
_HALO_MAX = 64   # upper bound on the speculative warm-up window
_TAIL = 2        # successor words after each range (its last word's window)


def _halo_words(spw: float) -> int:
    """Warm-up words per sub-block, sized to ~56 decoded codewords from the
    header-known mean codeword starts per word ``spw``."""
    return max(8, min(_HALO_MAX, int(56.0 / max(spw, 0.5))))


def _chunk_words(j: int) -> int:
    """Words per TPU grid chunk; the router's slot-axis rule uses it."""
    wc = 16
    while wc * 2 * j * _SB <= 8192:
        wc *= 2
    return wc


def _local_width(n_samples: int, parts: int) -> int:
    """Per-sub-block output width: mean local count + slack; sub-blocks
    whose counts overrun it are flagged for exact re-decode."""
    mean = -(-n_samples // parts)
    return -(-(mean + max(mean // 8, 192)) // 128) * 128


def decode_split_parts(nseg: int, wmax: int, k: int) -> int:
    """Sub-blocks per segment for the split decode (1 = don't split): the
    JAX router (``split_decode.py:327-356``) with the non-split decode at
    the full rate, as the port's B2 decodes."""
    j = codewords_per_word(k)
    if wmax * j < (1 << 15) and nseg >= _SB * _LANES:
        return 1
    wc = _chunk_words(j)
    for parts in (2, 4, 8, 16, 32, 64):
        wsub = -(-wmax // parts)
        if wsub < 256 or nseg * parts > (1 << 14):
            return 1
        width = -(-(_HALO_MAX + wsub + _TAIL) // wc) * wc
        if (nseg * parts >= _SB * _LANES
                and (width - 1) * (j - 1) + _HALO_MAX + j < (1 << 15)
                and width * j < (1 << 15)):
            return parts
    return 1


def _compose_merge(local: torch.Tensor, ent, ext, nloc, accf, wv2, nv,
                   n_samples: int, parts: int, lw: int, delta: bool):
    """Junction checks, count and delta chaining, and the ragged row merge
    (``split_decode.py:270-324``).

    local: (nseg*parts, lw) int16 per-sub-block samples; ent, ext, nloc,
    accf: (nseg*parts,) int32 from B9; wv2: (nseg, parts) owned words;
    nv: (nseg,) true sample counts. Returns ((nseg, n_samples) int16,
    (nseg,) bool bad flags) on ``local``'s device.
    """
    nseg = local.shape[0] // parts
    e2, x2 = ent.reshape(nseg, parts), ext.reshape(nseg, parts)
    n2 = nloc.reshape(nseg, parts).to(torch.int64)
    a2 = accf.reshape(nseg, parts).to(torch.int64)
    nv = nv.to(torch.int64)
    # the speculated entry phase must equal the predecessor's exit phase
    # (junctions into empty sub-blocks, a short segment's suffix, skip)
    okj = (e2[:, 1:] == x2[:, :-1]) | (wv2[:, 1:] == 0)
    bad = ~okj.all(dim=1)
    n_off = torch.cumsum(n2, dim=1) - n2
    # phantom codewords of the trailing zero fill sit past the segment's
    # count and clip off here
    n_eff = torch.minimum((nv[:, None] - n_off).clamp(min=0), n2)
    bad |= n_eff.sum(dim=1) != nv
    bad |= (n_eff > lw).any(dim=1)
    v = local.reshape(nseg, parts, lw).to(torch.int32)
    if delta:
        # entry state of sub-block p = wrapping sum of the earlier ones'
        # final values (the merge keeps the low halfword)
        v = v + (torch.cumsum(a2, dim=1) - a2).to(torch.int32)[:, :, None]
    i = torch.arange(lw, device=local.device)
    dispc = (torch.arange(parts, device=local.device)[None, :] * lw
             - n_off)[:, :, None]
    real = i < n_eff[:, :, None]
    keep = real & (dispc >= 0) & (dispc < (1 << 16) - 1)
    # a displacement past the 16-bit field only comes from counts skewed
    # far from uniform; those segments re-decode exactly
    bad |= (real & ~keep).any(dim=2).any(dim=1)
    plane = torch.where(keep, biased_plane(dispc.clamp(0, (1 << 16) - 1),
                                           v & 0xFFFF), DEAD)
    out = concentrate_wide16(plane.reshape(nseg, parts * lw), n_samples)
    return (((out & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.int16), bad


def unpack_decode_split(words: torch.Tensor, counts, n_samples: int,
                        k: int, delta: bool, parts: int, nvalid=None):
    """Split-decode per-segment Rice streams (see the module docstring).

    words: (nseg, W) int32 segment-major streams (>= 1 zero pad word per
    stream); counts: (nseg,) true word counts from the header walk;
    nvalid: (nseg,) true sample counts (default ``n_samples`` each).
    Returns ((nseg, n_samples) int16, (nseg,) bool bad) on ``words``'
    device; flagged segments' samples are invalid and must be re-decoded
    exactly.
    """
    nseg = words.shape[0]
    dev = words.device
    counts = np.asarray(counts, dtype=np.int64)
    wsub = -(-int(counts.max(initial=1)) // parts)
    halo = _halo_words(n_samples / max(float(counts.mean()), 1.0))
    lw = _local_width(n_samples, parts)
    wv2 = np.clip(
        counts[:, None] - np.arange(parts, dtype=np.int64)[None, :] * wsub,
        0, wsub,
    ).astype(np.int32)
    nv = (np.full(nseg, n_samples, np.int64) if nvalid is None
          else np.asarray(nvalid, dtype=np.int64))
    # both copies in go before the kernel: a pageable copy waits for the
    # stream, and must not wait for this decode's own kernels
    wv2_t = torch.from_numpy(wv2).to(dev)
    nv_t = torch.from_numpy(nv).to(dev)
    local, meta = split_decode(words, wv2_t.reshape(-1), parts, wsub, halo,
                               lw, k, delta)
    return _compose_merge(local, *meta, wv2_t, nv_t, n_samples, parts, lw,
                          delta)
