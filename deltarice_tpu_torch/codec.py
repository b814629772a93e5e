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
  the B1/B2 kernels, one thread per segment, between B4 transposes that
  give them coalesced sample-major / word-major arrays. Both kernels store
  at final offsets, so there is no staging or placement pass.
* host (numpy + the native C helpers): the variable-length framing — the
  header walk and the ragged gather / scatter at memcpy speed.

Every entry point takes ``device``; a ``"cpu"`` device runs the kernels'
plain torch versions. Words are int32 tensors holding uint32 bit patterns
on the device and uint32 arrays on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import RiceConfig
from .ops.pack_cuda import pack_encode
from .ops.prefilter import prefilter_decode, prefilter_encode
from .ops.transpose_cuda import transpose2d
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
                         prev0=None, device="cuda"):
    """:func:`encode_segments` plus exact per-stream bit counts and an
    optional initial delta state (``prev0``, delta filter only: the
    sample before each segment). Returns (words, nwords, nbits) on
    ``device``."""
    x = _on(x, device, torch.int16)
    nv = _on(nvalid, device, torch.int32)
    p0 = None if prev0 is None else _on(prev0, device, torch.int32)
    if not cfg.is_delta:
        if p0 is not None:
            raise ValueError("prev0 is only supported for the delta filter")
        x = prefilter_encode(x, cfg.filt)
    xt = transpose2d(x)
    words_t, nwords, nbits = pack_encode(xt, nv, p0, cfg.k, cfg.is_delta,
                                         max_words)
    return transpose2d(words_t), nwords, nbits


def decode_segments(words, n_samples: int, cfg: RiceConfig,
                    device="cuda") -> torch.Tensor:
    """Decode per-segment word streams back to int16 samples.

    words: (num_segments, W) uint32 array, or int32 tensor of uint32 bit
    patterns, with at least one zero pad word per row.
    Returns (num_segments, n_samples) int16 on ``device`` (the tail of short
    segments is garbage; callers slice by true counts).
    """
    if isinstance(words, np.ndarray):
        words = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    w = _on(words, device, torch.int32)
    out_t = unpack_decode(transpose2d(w), n_samples, cfg.k, cfg.is_delta)
    out = transpose2d(out_t)
    if not cfg.is_delta:
        out = prefilter_decode(out, cfg.filt)
    return out


def _on(a, device, dtype) -> torch.Tensor:
    """Array or tensor -> contiguous ``dtype`` tensor on ``device`` (a
    read-only array is copied first: torch cannot share it)."""
    if isinstance(a, np.ndarray) and not a.flags.writeable:
        a = a.copy()
    return torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()


def _segment_layout(total: int, cfg: RiceConfig):
    nseg, length, leftover = cfg.segments(total)
    nvalid = np.full(nseg, length, dtype=np.int32)
    if leftover:
        nvalid[-1] = leftover
    return nseg, length, nvalid


def _words_hint(x: np.ndarray, cfg: RiceConfig, length: int) -> int:
    """Estimated per-segment output word cap (bucketed) for the encode.

    The worst-case bound (25 bits/sample) is 4-5x the typical compressed
    size; the encoder's output width, and the transpose after it, scale
    with the cap. This caps the width at a host subsample's largest
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

    With ``verify=True`` every stream is decoded back and compared to its
    input; chunks that fail re-encode individually up to ``retries`` times,
    and persistent failure raises ``RuntimeError``.
    """
    handle = compress_batch_dispatch(chunks, cfg, device)
    return compress_batch_collect(handle, cfg, verify, retries)


def compress_batch_dispatch(chunks, cfg: RiceConfig = RiceConfig(),
                            device="cuda"):
    """Queue the device encode of a chunk batch and return a handle.

    The handle holds device tensors; :func:`compress_batch_collect` moves
    them to the host and frames the streams, so a caller can overlap one
    window's framing and file I/O with the next window's encode.
    ``collect(dispatch(x)) == compress_batch(x)`` byte for byte.
    """
    arrs = [as_int16(c).ravel() for c in chunks]
    if not arrs:
        return (arrs, 0, None, None, device)
    total = arrs[0].size
    if any(a.size != total for a in arrs):
        raise ValueError("compress_batch requires equal-sized chunks")
    if total == 0:  # header-only streams, matching the native C codec
        return (arrs, 0, None, None, device)
    x2, nv, length = _padded_rows(arrs, total, cfg)
    cap = _words_hint(x2, cfg, length)
    words, nwords = encode_segments(x2, nv, cfg, cap, device)
    return (arrs, total, words, nwords, device)


def _padded_rows(arrs, total: int, cfg: RiceConfig):
    """Chunks -> (rows (nchunks*nseg, L) int16 zero-padded, nvalid, L)."""
    nseg, length, nvalid = _segment_layout(total, cfg)
    padded = np.zeros((len(arrs), nseg, length), dtype=np.int16)
    padded.reshape(len(arrs), -1)[:, :total] = np.stack(arrs)
    return (padded.reshape(len(arrs) * nseg, length),
            np.tile(nvalid, len(arrs)), length)


def compress_batch_collect(handle, cfg: RiceConfig = RiceConfig(),
                           verify: bool = False,
                           retries: int = 2) -> list[bytes]:
    """Fetch and frame the streams of a :func:`compress_batch_dispatch`."""
    arrs, total, words, nwords, device = handle
    if not arrs:
        return []
    if total == 0:
        return [np.zeros(1, dtype="<u4").tobytes() for _ in arrs]
    nchunks = len(arrs)
    nseg = _segment_layout(total, cfg)[0]
    # fetch the word counts first, then move only ~compressed-size bytes
    nw = nwords.cpu().numpy()
    w = max(int(nw.max(initial=0)), 1)
    cap = words.shape[1]
    wn = _host_words(words[:, : min(w, cap)])
    if w > cap:
        wn = np.pad(wn, ((0, 0), (0, w - cap)))
    over = nw > cap
    if over.any():  # rows past the cap re-encode exactly at the full bound
        x2, nv, length = _padded_rows(arrs, total, cfg)
        wn = _reencode_bad_rows(wn, x2, nv, over, cfg, cfg.max_words(length),
                                device)
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
    per-chunk retry path.
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
    """Decompress a framed byte stream back to a flat int16 array."""
    return decompress_batch([stream], cfg, device)[0]


def decompress_batch(streams, cfg: RiceConfig = RiceConfig(),
                     device="cuda") -> list[np.ndarray]:
    """Decompress many chunks' framed streams, one device decode per
    word-count bucket.

    All streams must describe the same sample count (uniform chunks).
    Chunks are grouped by their padded word width so one escape-heavy
    chunk only widens its own bucket, not the whole batch."""
    return decompress_batch_collect(
        decompress_batch_dispatch(streams, cfg, device)
    )


def decompress_batch_dispatch(streams, cfg: RiceConfig = RiceConfig(),
                              device="cuda"):
    """Run the host side (header walk, ragged gather), queue each bucket's
    device decode and return a handle of device tensors for
    :func:`decompress_batch_collect`."""
    streams = list(streams)
    if not streams:
        return (0, 0, [])
    bufs = [np.frombuffer(memoryview(s), dtype="<u4") for s in streams]
    if any(b.size == 0 for b in bufs):
        raise ValueError("truncated Delta-Rice stream")
    total = int(bufs[0][0])
    if any(int(b[0]) != total for b in bufs):
        raise ValueError("decompress_batch requires equal-sized chunks")
    if total == 0:
        return (len(bufs), 0, [])
    nseg, length, _nvalid = _segment_layout(total, cfg)
    by_bucket: dict[int, list[int]] = {}
    per_chunk = []
    for i, buf in enumerate(bufs):
        counts, starts = walk_headers(buf, nseg)
        per_chunk.append((buf, counts, starts))
        bucket = -(-(int(counts.max(initial=0)) + 1) // _WORD_BUCKET)
        by_bucket.setdefault(bucket * _WORD_BUCKET, []).append(i)
    pending = []
    for bucket, idxs in by_bucket.items():
        words = np.zeros((len(idxs), nseg, bucket), dtype=np.uint32)
        for j, i in enumerate(idxs):
            buf, counts, starts = per_chunk[i]
            words[j] = gather_segments(buf, counts, starts, bucket)
        dec = decode_segments(words.reshape(-1, bucket), length, cfg, device)
        pending.append((idxs, dec))
    return (len(bufs), total, pending)


def decompress_batch_collect(handle) -> list[np.ndarray]:
    """Fetch the samples of a :func:`decompress_batch_dispatch`."""
    n, total, pending = handle
    if n == 0:
        return []
    if total == 0:
        return [np.zeros(0, dtype=np.int16) for _ in range(n)]
    out: list[np.ndarray | None] = [None] * n
    for idxs, dec in pending:
        dec_np = dec.cpu().numpy().reshape(len(idxs), -1)
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
                    bucket: int = _WORD_BUCKET) -> np.ndarray:
    """Scatter the ragged per-segment words into a padded dense matrix
    (native C + OpenMP when built, numpy fallback)."""
    from .native import codec_lib

    nseg = counts.shape[0]
    maxw = int(counts.max(initial=0)) + 1  # +1 pad word for the 64-bit window
    maxw = -(-maxw // bucket) * bucket
    words = np.zeros((nseg, maxw), dtype=np.uint32)
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
