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
* long segments (nEDM 81920, NOPTREX 500000 samples) encode whole through
  B1, as short ones do; the decode can split each stream speculatively
  (B9 + B6, ``DELTARICE_TPU_SPLIT_DECODE=1``).
* host (numpy + the native C helpers): the variable-length framing — the
  header walk and the ragged gather / scatter at memcpy speed.
* windows: ``*_dispatch`` queues a batch's copies in (from pinned staging),
  its kernels and the copies of its results into pinned host memory on the
  current stream without waiting, and records a CUDA event; ``*_collect``
  waits on that event only, so it never waits for a later window's kernels
  (the h5 layer's one-window-deep pipeline). What collect must still run on
  the card (over-cap re-encodes, re-decodes of flagged segments,
  verification) runs on a second stream.

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

from . import tracing
from .config import RiceConfig
from .ops.pack_cuda import pack_encode
from .ops.prefilter import prefilter_decode, prefilter_encode
from .ops.split_decode import decode_split_parts, unpack_decode_split
from .ops.unpack_cuda import unpack_decode

_WORD_BUCKET = 256  # decode pads segment word counts up to a multiple of this


def encode_segments(x, nvalid, cfg: RiceConfig, max_words: int,
                    device="cuda"):
    """Encode padded segments of any length, each whole through B1.

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
    with tracing.span("encode_segments", words=max_words) as sp:
        with tracing.span("stage"):
            x = _on(x, device, torch.int16)
            nv = _on(nvalid, device, torch.int32)
        if sp is not None:
            sp.rows, sp.length = x.shape
        tracing.counters["rows_encoded"] += x.shape[0]
        if not cfg.is_delta:
            tracing.counters["rows_prefiltered"] += x.shape[0]
            with tracing.span("prefilter"), tracing.device("prefilter", x):
                x = prefilter_encode(x, cfg.filt)
        words, nwords, _nbits = pack_encode(x, nv, None, cfg.k, cfg.is_delta,
                                            max_words)
        return words, nwords


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
    with tracing.span("split_decode"):
        out, bad = unpack_decode_split(words, counts, n_samples, cfg.k,
                                       cfg.is_delta, parts, nvalid)
    if not cfg.is_delta:
        out = _prefilter_inverse(out, cfg)
    return out, bad


def _redecode_bad_rows(out_np: np.ndarray, bad, words_np: np.ndarray,
                       n_samples: int, cfg: RiceConfig,
                       device) -> np.ndarray:
    """Exactly re-decode (B2) the segments flagged in ``bad``, in place."""
    idx = np.nonzero(np.asarray(bad))[0]
    if idx.size == 0:
        return out_np
    tracing.counters["rows_redecoded"] += idx.size
    with tracing.span("redecode", rows=idx.size):
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
    with tracing.span("decode_segments", length=n_samples) as sp:
        w, out, bad = _decode_dispatch(words, n_samples, cfg, device, counts,
                                       nvalid)
        if sp is not None:
            sp.rows, sp.words = w.shape
        if bad is not None and bool(bad.any()):
            out = torch.from_numpy(_redecode_bad_rows(
                out.cpu().numpy(), bad.cpu().numpy(), _host_words(w),
                n_samples, cfg, device)).to(device)
        return out


def _decode_dispatch(words, n_samples: int, cfg: RiceConfig, device,
                     counts=None, nvalid=None):
    """Queue the decode of :func:`decode_segments` without waiting for the
    card: (words on ``device``, samples, the split decode's per-segment
    bad flags or None)."""
    with tracing.span("stage"):
        if isinstance(words, np.ndarray):
            words = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
        w = _on(words, device, torch.int32)
    tracing.counters["rows_decoded"] += w.shape[0]
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
        out = _prefilter_inverse(out, cfg)
    return w, out, None


def _prefilter_inverse(d: torch.Tensor, cfg: RiceConfig) -> torch.Tensor:
    """The generic pre-filter's inverse of decoded rows, counted, spanned
    and timed on the card."""
    tracing.counters["rows_prefilter_inverted"] += d.shape[0]
    with tracing.span("prefilter_inverse"), \
            tracing.device("prefilter_inverse", d):
        return prefilter_decode(d, cfg.filt)


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


def _reencode_rows(words_np: np.ndarray, idx: np.ndarray, x: np.ndarray,
                   nvalid: np.ndarray, cfg: RiceConfig, max_words: int,
                   device) -> np.ndarray:
    """Exactly re-encode rows ``idx`` of ``words_np`` at ``max_words``
    width, in place, from ``x`` and ``nvalid``, which hold those rows alone
    (one row each, in the order of ``idx``). ``words_np`` must be wide
    enough for every row's true word count."""
    if idx.size == 0:
        return words_np
    tracing.counters["rows_reencoded"] += idx.size
    with tracing.span("reencode", rows=idx.size):
        wfix, _nw = encode_segments(x, nvalid, cfg, max_words, device)
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

    On a CUDA device the words and their counts are copied into pinned host
    memory behind the kernels and the handle holds an event recorded after
    them; :func:`compress_batch_collect` waits on that event only, then
    frames the streams, so a caller can overlap one window's framing and
    file I/O with the next window's encode.
    ``collect(dispatch(x)) == compress_batch(x)`` byte for byte.
    """
    with tracing.span("compress_batch_dispatch") as sp:
        arrs = [as_int16(c).ravel() for c in chunks]
        if sp is not None:
            sp.chunks = len(arrs)
        if not arrs:
            return (arrs, 0, None, None, device, None)
        total = arrs[0].size
        if any(a.size != total for a in arrs):
            raise ValueError("compress_batch requires equal-sized chunks")
        if total == 0:  # header-only streams, matching the native C codec
            return (arrs, 0, None, None, device, None)
        with tracing.span("pad_rows"):
            x2, nv, length = _padded_rows(arrs, total, cfg)
        with tracing.span("words_hint"):
            cap = _words_hint(x2, cfg, length)
        words, nwords = encode_segments(x2, nv, cfg, cap, device)
        if _is_cuda(device):  # the whole capped width: max(nwords) is unknown
            with tracing.span("pinned_copy"):
                words, nwords = _pinned_copy(words), _pinned_copy(nwords)
        return (arrs, total, words, nwords, device, _window_ready(device))


def _padded_rows(arrs, total: int, cfg: RiceConfig, rows=None):
    """Chunks -> (rows (nchunks*nseg, L) int16 zero-padded, nvalid, L).
    ``rows`` (flat row indices) pads those rows alone, in its order."""
    nseg, length, nvalid = _segment_layout(total, cfg)
    if rows is None:
        padded = np.zeros((len(arrs), nseg * length), dtype=np.int16)
        for row, a in zip(padded, arrs):
            row[:total] = a
        return (padded.reshape(len(arrs) * nseg, length),
                np.tile(nvalid, len(arrs)), length)
    padded = np.zeros((len(rows), length), dtype=np.int16)
    for row, r in zip(padded, rows):
        chunk, seg = divmod(int(r), nseg)
        row[: nvalid[seg]] = arrs[chunk][seg * length:][: nvalid[seg]]
    return padded, nvalid[np.asarray(rows) % nseg], length


def compress_batch_collect(handle, cfg: RiceConfig = RiceConfig(),
                           verify: bool = False,
                           retries: int = 2) -> list[bytes]:
    """Fetch and frame the streams of a :func:`compress_batch_dispatch`.

    Waits on the window's event only. Over-cap re-encodes and verification
    run on the collect stream (:func:`_collect_stream`)."""
    arrs, total, words, nwords, device, ready = handle
    if not arrs:
        return []
    if total == 0:
        return [np.zeros(1, dtype="<u4").tobytes() for _ in arrs]
    with tracing.span("compress_batch_collect", chunks=len(arrs)):
        if ready is not None:
            with tracing.span("wait"):
                ready.synchronize()
        with _collect_stream(device):
            return _frame_collected(arrs, total, words, nwords, device, cfg,
                                    verify, retries)


def _frame_collected(arrs, total, words, nwords, device, cfg, verify,
                     retries) -> list[bytes]:
    nchunks = len(arrs)
    nseg = _segment_layout(total, cfg)[0]
    # word counts first: a CPU device then reads only ~compressed-size words
    nw = nwords.cpu().numpy()
    w = max(int(nw.max(initial=0)), 1)
    cap = words.shape[1]
    wn = _host_words(words[:, : min(w, cap)])
    if w > cap:
        wn = np.pad(wn, ((0, 0), (0, w - cap)))
    over = np.nonzero(nw > cap)[0]
    if over.size:  # rows past the cap re-encode exactly at the full bound
        x2, nv, length = _padded_rows(arrs, total, cfg, over)
        wn = _reencode_rows(wn, over, x2, nv, cfg, cfg.max_words(length),
                            device)
    nw = nw.reshape(nchunks, nseg)
    wn = wn.reshape(nchunks, nseg, -1)
    with tracing.span("frame", chunks=nchunks):
        streams = [frame_stream(total, wn[c], nw[c]) for c in range(nchunks)]
    if verify:
        with tracing.span("verify", chunks=nchunks):
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
        tracing.counters["verify_retries"] += len(bad)
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
    with tracing.span("decompress_batch_dispatch", chunks=len(streams)):
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
        with tracing.span("walk_headers", chunks=len(bufs)):
            for i, buf in enumerate(bufs):
                counts, starts = walk_headers(buf, nseg)
                per_chunk.append((buf, counts, starts))
                bucket = -(-(int(counts.max(initial=0)) + 1) // _WORD_BUCKET)
                by_bucket.setdefault(bucket * _WORD_BUCKET, []).append(i)
        pending = []
        for bucket, idxs in by_bucket.items():
            shape = (len(idxs) * nseg, bucket)
            with tracing.span("gather", rows=shape[0], words=bucket):
                staged = (torch.zeros(shape, dtype=torch.int32,
                                      pin_memory=True) if cuda else None)
                words2 = (np.zeros(shape, dtype=np.uint32) if staged is None
                          else staged.numpy().view(np.uint32))
                for j, i in enumerate(idxs):
                    buf, counts, starts = per_chunk[i]
                    gather_segments(buf, counts, starts, bucket,
                                    out=words2[j * nseg : (j + 1) * nseg])
            with tracing.span("decode_bucket", rows=shape[0], length=length,
                              words=bucket):
                _w, dec, bad = _decode_dispatch(
                    words2 if staged is None else staged, length, cfg, device,
                    np.concatenate([per_chunk[i][1] for i in idxs]),
                    np.tile(nvalid, len(idxs)))
            if cuda:  # samples and flags land in pinned memory behind the
                # kernels
                with tracing.span("pinned_copy"):
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
    with tracing.span("decompress_batch_collect", chunks=n):
        if ready is not None:
            with tracing.span("wait"):
                ready.synchronize()
        out: list[np.ndarray | None] = [None] * n
        with _collect_stream(device):
            for idxs, dec, bad, words2 in pending:
                dec_np = dec.cpu().numpy()
                if bad is not None:
                    dec_np = _redecode_bad_rows(dec_np, bad.cpu().numpy(),
                                                words2, length, cfg, device)
                with tracing.span("copy_out", chunks=len(idxs)):
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
