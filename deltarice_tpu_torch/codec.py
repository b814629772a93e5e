"""Chunk-level Delta-Rice codec on PyTorch: segmentation, device encode and
decode through the CUDA kernels, and the framed byte-stream layout.

Frame layout (frozen; the reference filter's
``writeWholeCompressedByteString`` / ``readWholeCompressedByteString``):

    u32 totalSamples | { u32 nWords_i | u32 words_i[nWords_i] } x numSegments

with ``numSegments = ceil(totalSamples / L)`` and the last segment holding the
leftover samples; ``L == -1`` means one segment spanning the chunk. Words are
little-endian uint32 on disk.

Split of responsibilities:

* device: pre-filter, zigzag, codeword math, bit packing and unpacking —
  the B1/B2 kernels, each parallel inside a segment (tiles of samples or
  words joined by prefix sums), on the segment-major arrays the codec
  holds. Both kernels store at final offsets, so there is no staging or
  placement pass.
* long segments (nEDM 81920, NOPTREX 500000 samples): the encode splits
  each segment into P sub-blocks across threads and merges the sub-streams
  at bit offsets in one concentration (B3 or B5); the decode can split each
  stream speculatively (B9 + B6, ``DELTARICE_TPU_SPLIT_DECODE=1``).
* host (numpy + the native C helpers): the variable-length framing — the
  header walk and the ragged gather / scatter at memcpy speed.
* windows: ``*_dispatch`` queues a batch's copies in (from pinned staging),
  its kernels and the copies of its results into pinned host memory on the
  current stream without waiting, and records a CUDA event; ``*_collect``
  waits on that event only, so it never waits for a later window's kernels
  (the h5 layer's one-window-deep pipeline). What collect must still run on
  the card (the split merge, over-cap re-encodes, re-decodes of flagged
  segments, verification) runs on a second stream.

Every entry point takes ``device``; a ``"cpu"`` device runs the kernels'
plain torch versions, with no pinning and no events. Words are int32
tensors holding uint32 bit patterns on the device and uint32 arrays on the
host.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from .config import RiceConfig
from .ops.concentrate import concentrate
from .ops.pack_cuda import pack_encode
from .ops.pack_ref import as_i32, as_u32
from .ops.prefilter import prefilter_decode, prefilter_encode
from .ops.split_decode import decode_split_parts, unpack_decode_split
from .ops.unpack_cuda import unpack_decode

_WORD_BUCKET = 256  # decode pads segment word counts up to a multiple of this


def encode_segments(x, nvalid, cfg: RiceConfig, max_words: int,
                    device="cuda"):
    """Encode padded segments.

    Args:
      x: (num_segments, L) int16 (array or tensor), zero-padded past each
        segment's nvalid.
      nvalid: (num_segments,) valid sample counts.
      cfg: codec parameters.
      max_words: output width; words at or past it are dropped while
        ``nwords`` stays exact (callers re-encode such rows wider).

    Returns:
      (words (num_segments, max_words) int32 uint32 bit patterns,
       nwords (num_segments,) int32), both on ``device``.
    """
    words, nwords, _ = encode_segments_bits(x, nvalid, cfg, max_words,
                                            device=device)
    return words, nwords


def encode_segments_bits(x, nvalid, cfg: RiceConfig, max_words: int,
                         prev0=None, prefiltered: bool = False,
                         device="cuda"):
    """:func:`encode_segments` plus exact per-stream bit counts and an
    optional initial delta state (``prev0``, delta filter only: the
    sample before each segment) — what the sub-block split needs (streams
    concatenate at bit offsets; delta chains continue across blocks).
    ``prefiltered`` takes ``x`` as already pre-filtered values and skips the
    filter (the generic-FIR split filters over a halo before splitting).
    Returns (words, nwords, nbits) on ``device``."""
    x = _on(x, device, torch.int16)
    nv = _on(nvalid, device, torch.int32)
    p0 = None if prev0 is None else _on(prev0, device, torch.int32)
    diff = cfg.is_delta and not prefiltered
    if not cfg.is_delta and p0 is not None:
        raise ValueError("prev0 is only supported for the delta filter")
    if not cfg.is_delta and not prefiltered:
        x = prefilter_encode(x, cfg.filt)
    return pack_encode(x, nv, p0, cfg.k, diff, max_words)


def _split_decode_enabled() -> bool:
    """Speculative split decode (B9 + B6, :mod:`.ops.split_decode`) is off by
    default, as in the JAX package, and read from the same variable:
    ``DELTARICE_TPU_SPLIT_DECODE=1`` turns it on. The JAX default rests on a
    TPU measurement; the port's default waits for the card's numbers."""
    return os.environ.get("DELTARICE_TPU_SPLIT_DECODE", "0") == "1"


def _decode_device_split(words: torch.Tensor, counts, n_samples: int,
                         cfg: RiceConfig, parts: int, nvalid=None):
    """Split decode of segment-major streams: (samples (nseg, n_samples),
    per-segment bad flags), both on the device. Flagged segments re-decode
    exactly through :func:`_redecode_bad_rows`. The generic-FIR inverse
    runs after the merge, as in :func:`decode_segments`."""
    out, bad = unpack_decode_split(words, counts, n_samples, cfg.k,
                                   cfg.is_delta, parts, nvalid)
    if not cfg.is_delta:
        out = prefilter_decode(out, cfg.filt)
    return out, bad


def _redecode_bad_rows(out_np: np.ndarray, bad, words_np: np.ndarray,
                       n_samples: int, cfg: RiceConfig,
                       device) -> np.ndarray:
    """Exactly re-decode (B2) the segments flagged in ``bad``, in place."""
    idx = np.nonzero(np.asarray(bad))[0]
    if idx.size == 0:
        return out_np
    if not out_np.flags.writeable:
        out_np = out_np.copy()
    fixed = decode_segments(words_np[idx], n_samples, cfg, device)
    out_np[idx] = fixed.cpu().numpy()
    return out_np


def decode_segments(words, n_samples: int, cfg: RiceConfig,
                    device="cuda", counts=None, nvalid=None) -> torch.Tensor:
    """Decode per-segment word streams back to int16 samples.

    words: (num_segments, W) uint32 array, or int32 tensor of uint32 bit
    patterns, with at least one zero pad word per row.
    counts / nvalid: optional per-segment word counts (from the header
    walk) and valid-sample counts; with both and the split switch on
    (:func:`_split_decode_enabled`), long streams decode speculatively in
    parallel pieces and flagged segments re-decode exactly.
    Returns (num_segments, n_samples) int16 on ``device`` (the tail of short
    segments is garbage; callers slice by true counts).
    """
    w, out, bad = _decode_dispatch(words, n_samples, cfg, device, counts,
                                   nvalid)
    if bad is not None and bool(bad.any()):
        out = torch.from_numpy(_redecode_bad_rows(
            out.cpu().numpy(), bad.cpu().numpy(), _host_words(w), n_samples,
            cfg, device)).to(device)
    return out


def _decode_dispatch(words, n_samples: int, cfg: RiceConfig, device,
                     counts=None, nvalid=None):
    """Queue the decode of :func:`decode_segments` without waiting for the
    card: (words on ``device``, samples, the split decode's per-segment
    bad flags or None)."""
    if isinstance(words, np.ndarray):
        words = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    w = _on(words, device, torch.int32)
    parts = 1
    if counts is not None and _split_decode_enabled():
        parts = decode_split_parts(w.shape[0],
                                   int(np.asarray(counts).max(initial=1)),
                                   cfg.k)
    if parts > 1:
        return (w, *_decode_device_split(w, counts, n_samples, cfg, parts,
                                         nvalid))
    out = unpack_decode(w, n_samples, cfg.k, cfg.is_delta)
    if not cfg.is_delta:
        out = prefilter_decode(out, cfg.filt)
    return w, out, None


def _on(a, device, dtype) -> torch.Tensor:
    """Array or tensor -> contiguous ``dtype`` tensor on ``device``.

    A host array bound for a CUDA device is staged in pinned memory and
    copied without blocking the host, in the current stream's order (a
    pageable copy would wait for every kernel queued before it). A
    read-only array is copied first for a CPU device: torch cannot share
    it."""
    if _is_cuda(device) and not isinstance(a, torch.Tensor):
        a = np.asarray(a)
        pin = torch.empty(a.shape, dtype=dtype, pin_memory=True)
        np.copyto(pin.numpy(), a, casting="unsafe")
        a = pin
    if isinstance(a, np.ndarray) and not a.flags.writeable:
        a = a.copy()
    return torch.as_tensor(a).to(device=device, dtype=dtype,
                                  non_blocking=True).contiguous()


def _is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """Queue the copy of a device tensor into new pinned host memory behind
    the current stream's work, without waiting: read it only after the
    window's event. The caching host allocator does not hand the block out
    again before the copy has completed."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t, non_blocking=True)


def _window_ready(device) -> "torch.cuda.Event | None":
    """Event behind everything a window queued on the current stream (its
    kernels and its copies into pinned memory); None on a CPU device."""
    if not _is_cuda(device):
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


_collect_streams: dict[int, "torch.cuda.Stream"] = {}


def _collect_stream(device):
    """Context for the device work a collect runs itself: a second stream
    of the card, so it runs beside a later window's kernels on the current
    stream instead of behind them. A no-op on a CPU device."""
    if not _is_cuda(device):
        return contextlib.nullcontext()
    dev = torch.device(device)
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    if idx not in _collect_streams:
        _collect_streams[idx] = torch.cuda.Stream(idx)
    return torch.cuda.stream(_collect_streams[idx])


def _segment_layout(total: int, cfg: RiceConfig):
    nseg, length, leftover = cfg.segments(total)
    nvalid = np.full(nseg, length, dtype=np.int32)
    if leftover:
        nvalid[-1] = leftover
    return nseg, length, nvalid


def _words_hint(x: np.ndarray, cfg: RiceConfig, length: int) -> int:
    """Estimated per-segment output word cap (bucketed) for the encode.

    The worst-case bound (25 bits/sample) is 4-5x the typical compressed
    size; the encoder's output width scales with the cap. This caps the width at a host subsample's largest
    per-row rate plus margin. The kernel's word counts are exact
    regardless, so rows that overflow the cap are detected for free and
    re-encoded at the full bound.
    """
    full = cfg.max_words(length)
    if not cfg.is_delta or x.ndim != 2 or x.shape[1] < 64:
        return full
    rows = x[:: max(1, x.shape[0] // 64)][:64]
    seg = rows[:, : min(rows.shape[1], 4096)].astype(np.int32)
    d = seg.copy()
    d[:, 1:] -= seg[:, :-1]
    d = (d << 16) >> 16
    u = (d << 1) ^ (d >> 31)
    q = u >> cfg.k
    ln = np.minimum(q, 8) + 1 + cfg.k + np.where(q >= 8, 16 - cfg.k, 0)
    bps = ln.mean(axis=1)  # per-row bits/sample over the subsample
    # margin: worst subsampled row + 20% + slack for rows outside the
    # subsample; sampling noise of a 4096-sample mean is tiny next to it
    est = float(bps.max()) * 1.2 * length / 32.0 + 64.0
    cap = -(-int(est) // _WORD_BUCKET) * _WORD_BUCKET
    return min(cap, full)


def _reencode_bad_rows(words_np: np.ndarray, x: np.ndarray,
                       nvalid: np.ndarray, bad, cfg: RiceConfig,
                       max_words: int, device) -> np.ndarray:
    """Exactly re-encode the rows flagged in ``bad`` at ``max_words``
    width, in place. ``words_np`` must be wide enough for every row's true
    word count."""
    idx = np.nonzero(np.asarray(bad))[0]
    if idx.size == 0:
        return words_np
    wfix, _nw = encode_segments(x[idx], nvalid[idx], cfg, max_words, device)
    if not words_np.flags.writeable:
        words_np = words_np.copy()
    words_np[idx] = _host_words(wfix[:, : words_np.shape[1]])
    return words_np


def _host_words(words: torch.Tensor) -> np.ndarray:
    """Device int32 bit patterns -> host uint32 array."""
    return words.cpu().numpy().view(np.uint32)


# --- sub-block-split encode for long segments ---------------------------
#
# A Rice stream is a bit concatenation of per-sample codewords, and the
# delta filter's only cross-sample state is the previous sample, so a long
# segment encodes as P independent sub-blocks across threads (each seeded
# with its predecessor's last sample) whose sub-streams then concatenate at
# bit offsets, byte-identical to the serial pass. The policy and layout are
# the JAX package's (``deltarice_tpu/codec.py:473-560``).

_SPLIT_MIN_SUB = 8192    # don't split below this sub-block length
_SPLIT_PACKED = 1 << 15  # sub-block length that keeps placement packed
_LANE_TARGET = 1024      # one full TPU kernel block of lanes


def _split_parts(nseg: int, length: int, cfg: RiceConfig) -> int:
    """Sub-blocks per segment (1 = no split); ``nseg`` is the segments of
    one chunk."""
    if length < 2 * _SPLIT_MIN_SUB:
        return 1
    parts = 1
    # fill the lane grid, then keep halving until the slot axis is packed
    while (length // (2 * parts) >= _SPLIT_MIN_SUB
           and (nseg * 2 * parts <= _LANE_TARGET
                or length // parts >= _SPLIT_PACKED)):
        parts *= 2
    return parts


def _split_layout(padded: np.ndarray, nvalid: np.ndarray, parts: int,
                  halo: int = 0):
    """(rows, L) -> ((rows*parts, halo+Ls), per-sub nvalid, per-sub prev0,
    Ls).

    ``halo`` leading samples per sub-block carry the predecessor's tail
    (zeros for the first block) — what a generic causal FIR pre-filter
    needs to produce the serial pass's outputs at block starts; the delta
    path uses ``prev0`` (its entire recurrence state) instead.
    """
    rows, length = padded.shape
    ls = -(-length // parts)
    xp = padded
    if parts * ls != length or halo:
        xp = np.zeros((rows, halo + parts * ls), padded.dtype)
        xp[:, halo : halo + length] = padded
        if halo:
            x3 = np.lib.stride_tricks.sliding_window_view(
                xp, halo + ls, axis=1
            )[:, ::ls][:, :parts]
        else:
            x3 = xp[:, halo:].reshape(rows, parts, ls)
    else:
        x3 = xp.reshape(rows, parts, ls)
    prev0 = np.zeros((rows, parts), np.int32)
    prev0[:, 1:] = x3[:, :-1, -1]
    nv = np.clip(
        nvalid[:, None] - np.arange(parts, dtype=np.int64)[None, :] * ls,
        0, ls,
    ).astype(np.int32)
    return (np.ascontiguousarray(x3.reshape(rows * parts, halo + ls)),
            nv.reshape(-1), prev0.reshape(-1), ls)


def _encode_split_rows(padded2d: np.ndarray, nvalid_rows: np.ndarray,
                       cfg: RiceConfig, parts: int, device):
    """Sub-block-split encode of (rows, L) at rate 1: (words, nwords, nbits,
    sub_length) on ``device``, one row per sub-block, words zero past each
    sub-stream. Delta seeds each block with its predecessor's last sample;
    generic FIR filters each block over a (ntaps-1)-sample halo of
    preceding raw samples — both reproduce the serial filter outputs
    exactly, so the merged stream is byte-identical."""
    if cfg.is_delta:
        xs, nv, p0, ls = _split_layout(padded2d, nvalid_rows, parts)
        w, nw, nb = encode_segments_bits(xs, nv, cfg, cfg.max_words(ls),
                                         prev0=p0, device=device)
    else:
        halo = len(cfg.filt) - 1
        xs, nv, _p0, ls = _split_layout(padded2d, nvalid_rows, parts, halo)
        d = prefilter_encode(_on(xs, device, torch.int16), cfg.filt)
        w, nw, nb = encode_segments_bits(d[:, halo:], nv, cfg,
                                         cfg.max_words(ls), prefiltered=True,
                                         device=device)
    return w, nw, nb, ls


def _merge_device(words3: torch.Tensor, nbits2: torch.Tensor,
                  out_w: int) -> torch.Tensor:
    """Device sub-stream merge (``deltarice_tpu/codec.py:563-639``):
    shifted-OR concatenation at bit offsets as ONE concentration.

    Pre-shifting part p's words by its start-bit remainder r gives
    ``sh[j] = src[j] >> r | src[j-1] << (32-r)``, whose word j lands at
    output word ``w0_p + j`` — a displacement constant per part. Each
    part's boundary tail word, which shares an output word with its
    successor, is pre-ORed into the successor's first shifted word
    (bit-disjoint by the packer's zero fill); where the successor starts
    word-aligned, or there is none, the tail extends the part's own run
    instead. Every output word then has exactly one source element.

    words3: (rows, parts, w_in) int32 bit patterns, zero past each stream
    and w_in above every part's last output word (see
    :func:`merge_substreams_device`); nbits2: (rows, parts) exact bit
    counts; every valid part but each row's last must span >= 2 output
    words. Returns (rows, out_w) int32 bit patterns.
    """
    rows, parts, w_in = words3.shape
    nb = nbits2.to(torch.int64)
    base = torch.cumsum(nb, dim=1) - nb
    w0 = base >> 5
    r2 = base & 31
    r = r2[:, :, None]
    src = as_u32(words3)
    prev = torch.nn.functional.pad(src[:, :, :-1], (1, 0))
    sh = torch.where(r == 0, src,
                     ((src >> r) | (prev << ((32 - r) & 31))) & 0xFFFFFFFF)
    m_a = ((base + nb - 1) >> 5) - w0  # whole-word run (tail excluded)
    valid = nb > 0
    in_row = (m_a >= 0) & (m_a < w_in)
    tails = torch.gather(sh, 2, m_a.clamp(0, w_in - 1)[:, :, None])[:, :, 0]
    tails = torch.where(in_row, tails, 0)
    # carry[p] = nearest preceding valid part's tail (skips empty parts)
    carry = torch.zeros_like(tails)
    c = torch.zeros_like(tails[:, 0])
    for p in range(parts):
        carry[:, p] = c
        c = torch.where(valid[:, p], tails[:, p], c)
    # extend[p]: keep the tail in part p's own run — the next valid part
    # starts word-aligned or doesn't exist
    extend = torch.zeros_like(valid)
    nxt_aligned = torch.ones_like(valid[:, 0])
    for p in reversed(range(parts)):
        extend[:, p] = nxt_aligned
        nxt_aligned = torch.where(valid[:, p], r2[:, p] == 0, nxt_aligned)
    extend &= valid
    sh[:, :, 0] |= torch.where(valid & (r2 != 0), carry, 0)
    j_idx = torch.arange(w_in, device=words3.device)[None, None, :]
    m3 = m_a[:, :, None]
    valid_a = valid[:, :, None] & ((j_idx < m3)
                                   | (extend[:, :, None] & (j_idx == m3)))
    p_idx = torch.arange(parts, device=words3.device)[None, :]
    disp_a = torch.where(valid_a, (p_idx * w_in - w0)[:, :, None], -1)
    return concentrate(as_i32(sh).reshape(rows, parts * w_in),
                       disp_a.to(torch.int32).reshape(rows, parts * w_in),
                       out_w)


def merge_substreams_device(words: torch.Tensor, nbits2: np.ndarray,
                            parts: int):
    """Merge sub-streams on the device: (merged uint32 (rows, maxw) on the
    host, nwords) — or None when a middle sub-stream holds fewer than 32
    bits (the merge needs whole words there; the split layout only makes
    that for a segment's last sub-block, but callers of the public host
    merge may not). ``words`` is the (rows*parts, W) split-encode output;
    only about the compressed bytes cross to the host.

    The shifted plane is one word wider than the widest sub-stream, so a
    part whose bits fill its last word's phase-shifted spill keeps its tail
    (the JAX package sizes it to the widest sub-stream alone).
    """
    nb = np.ascontiguousarray(nbits2, dtype=np.int64)
    nz = nb > 0
    if nz.any():
        # every valid part except each row's last must span >= 2 output
        # words (its boundary word must not also be its first)
        base = np.cumsum(nb, axis=1) - nb
        m_a = ((base + nb - 1) >> 5) - (base >> 5)
        idx = np.arange(nb.shape[1])[None, :]
        last_nz = nb.shape[1] - 1 - np.argmax(nz[:, ::-1], axis=1)
        if (nz & (m_a < 1) & (idx != last_nz[:, None])).any():
            return None
    w3, nbt, out_w, nwords = _merge_inputs(words, nb, parts)
    maxw = int(nwords.max(initial=0))
    return _host_words(_merge_device(w3, nbt, out_w)[:, :maxw]), nwords


def _merge_inputs(words: torch.Tensor, nb: np.ndarray, parts: int):
    """What :func:`_merge_device` takes for the split-encode output
    ``words`` (rows*parts, W) and its (rows, parts) int64 bit counts ``nb``:
    (words3 (rows, parts, w_in), bit counts on the device, out_w, merged
    word counts (rows,) on the host)."""
    rows = nb.shape[0]
    nwords = (nb.sum(axis=1) + 31) >> 5
    maxw = int(nwords.max(initial=0))
    out_w = max(-(-(maxw + 1) // _WORD_BUCKET) * _WORD_BUCKET, parts)
    sub = int((nb.max(initial=0) + 31) >> 5)
    w = -(-(sub + 1) // _WORD_BUCKET) * _WORD_BUCKET
    w3 = words[:, : min(w, words.shape[1])]
    if w3.shape[1] < w:
        w3 = torch.nn.functional.pad(w3, (0, w - w3.shape[1]))
    return (w3.reshape(rows, parts, w), torch.from_numpy(nb).to(words.device),
            out_w, nwords)


def merge_substreams(words3: np.ndarray, nbits2: np.ndarray):
    """Concatenate per-sub-block word streams at bit offsets (host side).

    words3: (rows, P, W) uint32 packed sub-streams, zero beyond each
      stream's words (the packer's zero fill makes the shifted OR
      collision-free).
    nbits2: (rows, P) exact bit lengths.

    Returns (merged (rows, max_words) uint32, nwords (rows,) int64) —
    byte-identical to serially encoding each row's full waveform. Runs in
    the native C library (OpenMP) when built, numpy otherwise.
    """
    rows, parts, w_in = words3.shape
    nb64 = np.ascontiguousarray(nbits2, dtype=np.int64)
    nwords = (nb64.sum(axis=1) + 31) >> 5
    maxw = int(nwords.max(initial=0))
    out = np.zeros((rows, maxw + 1), dtype=np.uint32)
    from .native import codec_lib

    lib = codec_lib()
    if lib is not None:
        words3 = np.ascontiguousarray(words3, dtype=np.uint32)
        lib.dr_merge_substreams(words3.ctypes.data, rows, parts, w_in,
                                nb64.ctypes.data, maxw + 1, out.ctypes.data)
        return out[:, :maxw], nwords
    # each part's words shift by the row's bit phase and OR into place; a
    # row's columns within one part are distinct, and words past a stream
    # are zero, so over-width stores OR zeros into the scratch column
    base = np.cumsum(nb64, axis=1) - nb64
    ridx = np.arange(rows)[:, None]
    for p in range(parts):
        mmax = int((nb64[:, p].max(initial=0) + 31) >> 5)
        if mmax == 0:
            continue
        w = words3[:, p, :mmax]
        r = (base[:, p] & 31).astype(np.uint32)[:, None]
        w0 = (base[:, p] >> 5)[:, None]
        phase = r != 0
        lo = np.where(phase, w >> r, w)
        hi = np.where(phase, w << ((np.uint32(32) - r) & np.uint32(31)),
                      np.uint32(0))
        cols = np.minimum(w0 + np.arange(mmax, dtype=np.int64)[None, :], maxw)
        out[ridx, cols] |= lo
        out[ridx, np.minimum(cols + 1, maxw)] |= hi
    return out[:, :maxw], nwords


def compress(data, cfg: RiceConfig = RiceConfig(), device="cuda") -> bytes:
    """Compress one chunk of int16 samples to the framed byte stream.

    ``data`` may be an int16 array, any 2-byte-item array (viewed as int16,
    matching the filter's type punning), or raw bytes of even length.
    """
    return compress_batch([data], cfg, device=device)[0]


def compress_batch(chunks, cfg: RiceConfig = RiceConfig(),
                   verify: bool = False, retries: int = 2,
                   device="cuda") -> list[bytes]:
    """Compress many equal-sized chunks in one device call.

    With ``verify=True`` every stream is decoded back on ``device`` and
    compared to its input; chunks that fail re-encode individually up to
    ``retries`` times (:func:`_verify_retry`), and persistent failure
    raises ``RuntimeError``.
    """
    handle = compress_batch_dispatch(chunks, cfg, device)
    return compress_batch_collect(handle, cfg, verify, retries)


def compress_batch_dispatch(chunks, cfg: RiceConfig = RiceConfig(),
                            device="cuda"):
    """Queue the device encode of a chunk batch and return a handle.

    On a CUDA device the words (or, for a split encode, the sub-stream
    bit counts the merge needs) are copied into pinned host memory behind
    the kernels and the handle holds an event recorded after them;
    :func:`compress_batch_collect` waits on that event only, then frames
    the streams, so a caller can overlap one window's framing and file I/O
    with the next window's encode.
    ``collect(dispatch(x)) == compress_batch(x)`` byte for byte.
    """
    arrs = [as_int16(c).ravel() for c in chunks]
    if not arrs:
        return (arrs, 0, None, None, device, None, 1, None)
    total = arrs[0].size
    if any(a.size != total for a in arrs):
        raise ValueError("compress_batch requires equal-sized chunks")
    if total == 0:  # header-only streams, matching the native C codec
        return (arrs, 0, None, None, device, None, 1, None)
    x2, nv, length = _padded_rows(arrs, total, cfg)
    parts = _split_parts(_segment_layout(total, cfg)[0], length, cfg)
    if parts > 1:  # long segments: sub-block split, merged in collect
        words, nwords, nbits, _ls = _encode_split_rows(x2, nv, cfg, parts,
                                                       device)
        if _is_cuda(device):  # the merge needs host bit counts; words stay
            nwords, nbits = _pinned_copy(nwords), _pinned_copy(nbits)
        return (arrs, total, words, nwords, device, nbits, parts,
                _window_ready(device))
    cap = _words_hint(x2, cfg, length)
    words, nwords = encode_segments(x2, nv, cfg, cap, device)
    if _is_cuda(device):  # the whole capped width: max(nwords) is unknown
        words, nwords = _pinned_copy(words), _pinned_copy(nwords)
    return (arrs, total, words, nwords, device, None, 1,
            _window_ready(device))


def _padded_rows(arrs, total: int, cfg: RiceConfig):
    """Chunks -> (rows (nchunks*nseg, L) int16 zero-padded, nvalid, L)."""
    nseg, length, nvalid = _segment_layout(total, cfg)
    padded = np.zeros((len(arrs), nseg * length), dtype=np.int16)
    for row, a in zip(padded, arrs):
        row[:total] = a
    return (padded.reshape(len(arrs) * nseg, length),
            np.tile(nvalid, len(arrs)), length)


def compress_batch_collect(handle, cfg: RiceConfig = RiceConfig(),
                           verify: bool = False,
                           retries: int = 2) -> list[bytes]:
    """Fetch and frame the streams of a :func:`compress_batch_dispatch`.

    Waits on the window's event only. Split sub-streams merge on the card
    when they are there (B3 or B5), and on the host for a CPU device; that
    merge, over-cap re-encodes and verification run on the collect stream
    (:func:`_collect_stream`)."""
    arrs, total, words, nwords, device, nbits, parts, ready = handle
    if not arrs:
        return []
    if total == 0:
        return [np.zeros(1, dtype="<u4").tobytes() for _ in arrs]
    if ready is not None:
        ready.synchronize()
    with _collect_stream(device):
        return _frame_collected(arrs, total, words, nwords, device, nbits,
                                parts, cfg, verify, retries)


def _frame_collected(arrs, total, words, nwords, device, nbits, parts, cfg,
                     verify, retries) -> list[bytes]:
    nchunks = len(arrs)
    nseg = _segment_layout(total, cfg)[0]
    # word counts first: a CPU device then reads only ~compressed-size words
    nw = nwords.cpu().numpy()
    w = max(int(nw.max(initial=0)), 1)
    if parts > 1:
        nb2 = nbits.cpu().numpy().reshape(nchunks * nseg, parts)
        if words.device.type == "cpu":
            wn, nw = merge_substreams(
                _host_words(words[:, :w]).reshape(nchunks * nseg, parts, w),
                nb2)
        else:
            words.record_stream(torch.cuda.current_stream())
            res = merge_substreams_device(words, nb2, parts)
            if res is None:
                # _split_layout makes every sub-block before a segment's
                # last non-empty one >= _SPLIT_MIN_SUB samples, so >= 32 bits
                raise RuntimeError("split encode made a middle sub-stream "
                                   "shorter than one word")
            wn, nw = res
    else:
        cap = words.shape[1]
        wn = _host_words(words[:, : min(w, cap)])
        if w > cap:
            wn = np.pad(wn, ((0, 0), (0, w - cap)))
        over = nw > cap
        if over.any():  # rows past the cap re-encode exactly at full bound
            x2, nv, length = _padded_rows(arrs, total, cfg)
            wn = _reencode_bad_rows(wn, x2, nv, over, cfg,
                                    cfg.max_words(length), device)
    nw = nw.reshape(nchunks, nseg)
    wn = wn.reshape(nchunks, nseg, -1)
    streams = [frame_stream(total, wn[c], nw[c]) for c in range(nchunks)]
    if verify:
        streams = _verify_retry(arrs, streams, cfg, retries, device)
    return streams


def _verify_retry(arrs, streams, cfg: RiceConfig, retries: int,
                  device) -> list[bytes]:
    """Round-trip-check every stream; re-encode failing chunks.

    One batched decode checks everything; only failing chunks pay the
    per-chunk retry path. A stream whose framing is broken makes the
    batched decode raise ``ValueError``; then each stream is checked on
    its own, and one that raises counts as failed. A chunk still failing
    after ``retries`` re-encodes raises ``RuntimeError`` naming it; no
    other exception comes from a damaged stream.
    """
    def bad_indices(idxs, blobs):
        try:
            decoded = decompress_batch(blobs, cfg, device)
        except ValueError:
            # a corrupted header poisons the whole batch decode; fall back
            # to per-stream checks so only the broken chunk retries
            decoded = []
            for b in blobs:
                try:
                    decoded.append(decompress(b, cfg, device))
                except ValueError:
                    decoded.append(None)
        return [
            i for i, out in zip(idxs, decoded)
            if out is None or not np.array_equal(out, arrs[i])
        ]

    bad = bad_indices(range(len(streams)), streams)
    for _ in range(max(retries, 0)):
        if not bad:
            break
        for i in bad:
            streams[i] = compress(arrs[i], cfg, device)
        bad = bad_indices(bad, [streams[i] for i in bad])
    if bad:
        raise RuntimeError(
            f"chunks {bad} failed round-trip verification after "
            f"{retries} retries"
        )
    return streams


def decompress(stream, cfg: RiceConfig = RiceConfig(),
               device="cuda") -> np.ndarray:
    """Decompress a framed byte stream back to a flat int16 array.

    A damaged stream raises ``ValueError`` (a truncation, framing that
    overruns the stream, an empty stream, a byte count that is no whole
    number of words) or decodes to garbage of its stated length; it never
    crashes, hangs or reads outside its words, on the CPU or the card."""
    return decompress_batch([stream], cfg, device)[0]


def decompress_batch(streams, cfg: RiceConfig = RiceConfig(),
                     device="cuda") -> list[np.ndarray]:
    """Decompress many chunks' framed streams, one device decode per
    word-count bucket.

    All streams must describe the same sample count (uniform chunks).
    Chunks are grouped by their padded word width so one escape-heavy
    chunk only widens its own bucket, not the whole batch. A stream that
    fails the header walk makes the whole call raise ``ValueError``; other
    damage leaves garbage in that stream's output alone, the garbage
    :func:`decompress` gives for it."""
    return decompress_batch_collect(
        decompress_batch_dispatch(streams, cfg, device)
    )


def decompress_batch_dispatch(streams, cfg: RiceConfig = RiceConfig(),
                              device="cuda"):
    """Run the host side (header walk, ragged gather into pinned staging on
    a CUDA device), queue each bucket's device decode and the copy of its
    samples (and split-decode flags) into pinned host memory, and return a
    handle with an event recorded after them for
    :func:`decompress_batch_collect`."""
    streams = list(streams)
    if not streams:
        return (0, 0, None, [])
    bufs = [np.frombuffer(memoryview(s), dtype="<u4") for s in streams]
    if any(b.size == 0 for b in bufs):
        raise ValueError("truncated Delta-Rice stream")
    total = int(bufs[0][0])
    if any(int(b[0]) != total for b in bufs):
        raise ValueError("decompress_batch requires equal-sized chunks")
    if total == 0:
        return (len(bufs), 0, None, [])
    cuda = _is_cuda(device)
    nseg, length, nvalid = _segment_layout(total, cfg)
    by_bucket: dict[int, list[int]] = {}
    per_chunk = []
    for i, buf in enumerate(bufs):
        counts, starts = walk_headers(buf, nseg)
        per_chunk.append((buf, counts, starts))
        bucket = -(-(int(counts.max(initial=0)) + 1) // _WORD_BUCKET)
        by_bucket.setdefault(bucket * _WORD_BUCKET, []).append(i)
    pending = []
    for bucket, idxs in by_bucket.items():
        shape = (len(idxs) * nseg, bucket)
        staged = (torch.zeros(shape, dtype=torch.int32, pin_memory=True)
                  if cuda else None)
        words2 = (np.zeros(shape, dtype=np.uint32) if staged is None
                  else staged.numpy().view(np.uint32))
        for j, i in enumerate(idxs):
            buf, counts, starts = per_chunk[i]
            gather_segments(buf, counts, starts, bucket,
                            out=words2[j * nseg : (j + 1) * nseg])
        _w, dec, bad = _decode_dispatch(
            words2 if staged is None else staged, length, cfg, device,
            np.concatenate([per_chunk[i][1] for i in idxs]),
            np.tile(nvalid, len(idxs)))
        if cuda:  # samples and flags land in pinned memory behind the kernels
            dec = _pinned_copy(dec)
            bad = None if bad is None else _pinned_copy(bad)
        pending.append((idxs, dec, bad, words2))
    return (len(bufs), total, (length, cfg, device, _window_ready(device)),
            pending)


def decompress_batch_collect(handle) -> list[np.ndarray]:
    """Fetch the samples of a :func:`decompress_batch_dispatch`, waiting on
    its event only; segments the split decode flagged re-decode exactly
    (B2) here, on the collect stream. Every returned array is a copy: none
    aliases pinned memory that a later window reuses."""
    n, total, meta, pending = handle
    if n == 0:
        return []
    if total == 0:
        return [np.zeros(0, dtype=np.int16) for _ in range(n)]
    length, cfg, device, ready = meta
    if ready is not None:
        ready.synchronize()
    out: list[np.ndarray | None] = [None] * n
    with _collect_stream(device):
        for idxs, dec, bad, words2 in pending:
            dec_np = dec.cpu().numpy()
            if bad is not None:
                dec_np = _redecode_bad_rows(dec_np, bad.cpu().numpy(),
                                            words2, length, cfg, device)
            dec_np = dec_np.reshape(len(idxs), -1)
            for j, i in enumerate(idxs):
                out[i] = dec_np[j, :total].copy()
    return out


def as_int16(data) -> np.ndarray:
    """View input as int16 samples (the filter compresses raw bytes in
    2-byte units regardless of the declared dtype)."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(data, dtype=np.uint8)
        if arr.size % 2:
            raise ValueError(f"input size not divisible by two: {arr.size}")
        return arr.view(np.int16)
    arr = np.asarray(data)
    if arr.dtype.itemsize == 2:
        return arr.view(np.int16)
    raw = arr.tobytes()
    if len(raw) % 2:
        raise ValueError(f"input size not divisible by two: {len(raw)}")
    return np.frombuffer(raw, dtype=np.int16)


def frame_stream(total: int, words: np.ndarray, nwords: np.ndarray) -> bytes:
    """Assemble the framed chunk from padded per-segment words (host side):
    the native C routine (OpenMP memcpy per segment) when built, else a
    numpy scatter."""
    counts = np.ascontiguousarray(nwords, dtype=np.int64)
    nseg = counts.shape[0]
    word_start = np.zeros(nseg + 1, dtype=np.int64)
    np.cumsum(counts, out=word_start[1:])
    total_words = int(word_start[-1])
    from .native import codec_lib

    lib = codec_lib()
    if lib is not None and words.shape[1] >= int(counts.max(initial=0)):
        raw = bytearray(4 * (1 + nseg + total_words))
        out = np.frombuffer(raw, dtype="<u4")
        offsets = 1 + np.arange(nseg, dtype=np.int64) + word_start[:-1]
        words = np.ascontiguousarray(words, dtype=np.uint32)
        lib.dr_frame_rows(
            words.ctypes.data, nseg, words.shape[1],
            counts.ctypes.data, offsets.ctypes.data, total,
            out.ctypes.data,
        )
        return bytes(raw)
    out = np.empty(1 + nseg + total_words, dtype="<u4")
    out[0] = total
    pos = 1 + np.arange(nseg, dtype=np.int64) + word_start[:-1]
    out[pos] = counts
    seg_of = np.repeat(np.arange(nseg, dtype=np.int64), counts)
    within = np.arange(total_words, dtype=np.int64) - np.repeat(word_start[:-1], counts)
    out[np.repeat(pos + 1, counts) + within] = words[seg_of, within]
    return out.tobytes()


def walk_headers(buf: np.ndarray, nseg: int):
    """Serial header walk: per-segment (word count, first-word offset).

    Each segment's length header can only be found after the previous one.
    Runs in the native C library when built, with a numpy fallback.
    """
    from .native import codec_lib

    counts = np.empty(nseg, dtype=np.int64)
    starts = np.empty(nseg, dtype=np.int64)
    lib = codec_lib()
    if lib is not None:
        buf = np.ascontiguousarray(buf)
        rc = lib.dr_walk_headers(
            buf.ctypes.data, buf.size, nseg,
            counts.ctypes.data, starts.ctypes.data,
        )
        if rc != 0:
            raise ValueError("truncated Delta-Rice stream")
        return counts, starts
    pos = 1
    for i in range(nseg):
        if pos >= buf.size:
            raise ValueError("truncated Delta-Rice stream")
        starts[i] = pos
        c = int(buf[pos])
        counts[i] = c
        pos += c + 1
    if pos > buf.size:
        raise ValueError("truncated Delta-Rice stream")
    return counts, starts


def gather_segments(buf: np.ndarray, counts: np.ndarray, starts: np.ndarray,
                    bucket: int = _WORD_BUCKET, out=None) -> np.ndarray:
    """Scatter the ragged per-segment words into a padded dense matrix
    (native C + OpenMP when built, numpy fallback). ``out``: a zeroed
    C-contiguous (nseg, padded width) uint32 array to fill in place."""
    from .native import codec_lib

    nseg = counts.shape[0]
    maxw = int(counts.max(initial=0)) + 1  # +1 pad word for the 64-bit window
    maxw = -(-maxw // bucket) * bucket
    if out is None:
        words = np.zeros((nseg, maxw), dtype=np.uint32)
    elif (out.shape != (nseg, maxw) or out.dtype != np.uint32
          or not out.flags.c_contiguous):
        raise ValueError(f"out must be a C-contiguous ({nseg}, {maxw}) "
                         f"uint32 array")
    else:
        words = out
    lib = codec_lib()
    if lib is not None:
        buf = np.ascontiguousarray(buf)
        counts = np.ascontiguousarray(counts, dtype=np.int64)
        starts = np.ascontiguousarray(starts, dtype=np.int64)
        lib.dr_gather_rows(
            buf.ctypes.data, nseg, counts.ctypes.data, starts.ctypes.data,
            maxw, words.ctypes.data,
        )
        return words
    seg_of = np.repeat(np.arange(nseg, dtype=np.int64), counts)
    within = np.arange(int(counts.sum()), dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts
    )
    words[seg_of, within] = buf[np.repeat(starts + 1, counts) + within]
    return words
