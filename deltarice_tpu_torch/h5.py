"""HDF5 integration via direct-chunk I/O, on the port's codec.

h5py's direct-chunk API (``write_direct_chunk`` / ``read_direct_chunk``)
moves raw compressed bytes between the file and the application; the codec
runs outside libhdf5 on windows of chunks, and the dataset still carries
filter ID 32025 and its ``cd_values`` in its creation property list, so the
files are byte-compatible with the native filter plugin and the JAX
package's ``deltarice_tpu.h5`` both ways.

Chunk semantics match the filter pipeline: every stored chunk is full-size;
edge chunks are padded with the fill value (zeros), compressed whole, and
sliced after decode.

Windows pipeline one deep: window i's copies and kernels are queued
(``*_dispatch``) before window i-1 is collected, and a collect waits on its
own window's event only, so window i's kernels run while window i-1's
streams are framed and written, or its samples handed back.

Every entry point takes ``device`` (default ``"cuda"``). The module never
imports h5py: it works on the group or dataset object it is given.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from . import codec, tracing
from .config import H5FILTER, RiceConfig


def _chunk_grid(shape, chunks):
    """Yield (grid_index, offset) for every chunk of a dataset."""
    counts = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*(range(n) for n in counts)):
        yield idx, tuple(i * c for i, c in zip(idx, chunks))


def _require_device(device) -> None:
    """Raise for a CUDA device without a card: no h5 path carries on
    on the CPU in its place."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA card "
                           f"is available")


def dataset_config(dset) -> RiceConfig:
    """Recover the codec config from a dataset's filter pipeline."""
    plist = dset.id.get_create_plist()
    for i in range(plist.get_nfilters()):
        code, _flags, cd_values, _name = plist.get_filter(i)
        if code == H5FILTER:
            return RiceConfig.from_cd_values(cd_values)
    raise ValueError(
        f"dataset {dset.name!r} has no deltarice filter (id {H5FILTER})"
    )


def create_dataset(group, name, shape, cfg: RiceConfig | None = None,
                   chunks=None, dtype="<i2", **kwds):
    """Create a chunked dataset tagged with the deltarice filter.

    Without ``chunks``, 2-D data with a fixed waveform length gets chunks of
    up to 32 whole rows; anything else is one chunk, and with
    ``waveform_length == -1`` each whole chunk is one segment.
    """
    cfg = cfg or RiceConfig()
    if chunks is None:
        if len(shape) == 2 and cfg.waveform_length not in (-1, 0):
            rows = max(1, min(shape[0], 32))
            chunks = (rows, shape[1])
        else:
            chunks = tuple(shape)
    return group.create_dataset(
        name,
        shape=shape,
        dtype=dtype,
        chunks=tuple(chunks),
        compression=H5FILTER,
        compression_opts=tuple(cfg.to_cd_values()),
        allow_unknown_filter=True,
        **kwds,
    )


#: chunks per device batch in the streaming windows: host memory stays flat
#: over a stream, at a few windows of chunks (two windows of source blocks,
#: a padded copy, pinned staging), while device batches stay large
DEFAULT_BATCH_CHUNKS = 64


def _windows(seq, n):
    for i in range(0, len(seq), n):
        yield seq[i : i + n]


def write_dataset(group, name, data, cfg: RiceConfig | None = None,
                  chunks=None, batch_chunks: int = DEFAULT_BATCH_CHUNKS,
                  verify: bool = False, device="cuda"):
    """Create and fill a dataset: chunks compress on ``device`` and the raw
    streams go to the file with ``write_direct_chunk`` (libhdf5 runs no
    filter).

    ``data`` may be a numpy array or any sliceable array-like, including
    an open h5py dataset, and is read ``batch_chunks`` chunks at a time, so
    a dataset of any size streams through bounded host memory.
    ``verify=True`` round-trip-checks every chunk and re-encodes failures
    before anything reaches the file.
    """
    _require_device(device)
    cfg = cfg or RiceConfig()
    if not (hasattr(data, "shape") and hasattr(data, "dtype")):
        data = np.asarray(data)
    shape = tuple(data.shape)
    dset = create_dataset(group, name, shape, cfg, chunks, dtype=data.dtype)
    chunk_shape = dset.chunks
    grid = list(_chunk_grid(shape, chunk_shape))

    def flush(prev):
        offsets, handle = prev
        blobs = codec.compress_batch_collect(handle, cfg, verify=verify)
        for off, blob in zip(offsets, blobs):
            dset.id.write_direct_chunk(off, blob)

    prev = None
    for window in _windows(grid, max(1, batch_chunks)):
        # one span a window: its blocks read and queued, then window i-1
        # collected and written
        with tracing.span("h5.write_window", chunks=len(window)):
            offsets, blocks = [], []
            for _idx, off in window:
                sel = tuple(slice(o, min(o + c, s))
                            for o, c, s in zip(off, chunk_shape, shape))
                block = np.asarray(data[sel])
                if block.shape != chunk_shape:  # edge chunk: zero-pad
                    full = np.zeros(chunk_shape, dtype=data.dtype)
                    full[tuple(slice(0, b) for b in block.shape)] = block
                    block = full
                offsets.append(off)
                blocks.append(block)
            # queue window i before collecting window i-1
            handle = codec.compress_batch_dispatch(blocks, cfg, device)
            if prev is not None:
                flush(prev)
            prev = (offsets, handle)
    if prev is not None:
        with tracing.span("h5.write_window", chunks=0):
            flush(prev)
    return dset


def iter_chunks(dset, cfg: RiceConfig | None = None,
                batch_chunks: int = DEFAULT_BATCH_CHUNKS, device="cuda"):
    """Yield ``(offset, chunk_array)`` for every chunk of a
    deltarice-compressed dataset, decoding ``batch_chunks`` chunks per
    device batch. Chunk arrays are full chunk-shaped (edge chunks included,
    zero-padded as stored). A chunk whose filter-mask bit says the filter
    was skipped at write time holds its samples raw and is passed through."""
    _require_device(device)
    cfg = cfg or dataset_config(dset)
    shape = dset.shape
    chunk_shape = dset.chunks
    itemsize = np.dtype(dset.dtype).itemsize
    nsamp16 = int(np.prod(chunk_shape)) * itemsize // 2
    filter_bit = _deltarice_filter_bit(dset)
    grid = list(_chunk_grid(shape, chunk_shape))

    def collect(prev):
        offsets, handle, raw = prev
        return list(zip(offsets, codec.decompress_batch_collect(handle))) + raw

    def emit(done):
        for off, flat in done:
            if flat.size != nsamp16:
                raise ValueError(f"chunk at {off}: expected {nsamp16} "
                                 f"samples, got {flat.size}")
            yield off, flat.view(dset.dtype).reshape(chunk_shape)

    prev = None
    for window in _windows(grid, max(1, batch_chunks)):
        # one span a window: its blobs read and queued, then window i-1
        # collected (the caller's work on its chunks lies outside)
        with tracing.span("h5.read_window", chunks=len(window)):
            offsets, blobs, raw = [], [], []
            for _idx, off in window:
                mask, blob = dset.id.read_direct_chunk(off)
                if mask & filter_bit:
                    # filter marked optional and skipped at write time: the
                    # stored bytes are the samples, not a compressed stream
                    raw.append((off, np.frombuffer(blob, dtype=np.int16)))
                else:
                    offsets.append(off)
                    blobs.append(blob)
            # queue window i before collecting window i-1
            handle = codec.decompress_batch_dispatch(blobs, cfg, device)
            done = [] if prev is None else collect(prev)
        yield from emit(done)
        prev = (offsets, handle, raw)
    if prev is not None:
        with tracing.span("h5.read_window", chunks=0):
            done = collect(prev)
        yield from emit(done)


def read_dataset(dset, cfg: RiceConfig | None = None,
                 batch_chunks: int = DEFAULT_BATCH_CHUNKS,
                 device="cuda") -> np.ndarray:
    """Read a deltarice-compressed dataset without running the HDF5 filter:
    raw chunk streams come back through ``read_direct_chunk`` and decode on
    ``device``, ``batch_chunks`` chunks per batch. Reads files written by
    the native plugin and the JAX package too."""
    shape = dset.shape
    chunk_shape = dset.chunks
    out = np.empty(shape, dtype=dset.dtype)
    for off, block in iter_chunks(dset, cfg, batch_chunks, device):
        sel = tuple(slice(o, min(o + c, s))
                    for o, c, s in zip(off, chunk_shape, shape))
        out[sel] = block[tuple(slice(0, s.stop - s.start) for s in sel)]
    return out


def _deltarice_filter_bit(dset) -> int:
    """Bit in ``read_direct_chunk``'s filter mask that marks the deltarice
    filter as skipped for a chunk (bit i = i-th pipeline filter)."""
    plist = dset.id.get_create_plist()
    for i in range(plist.get_nfilters()):
        if plist.get_filter(i)[0] == H5FILTER:
            return 1 << i
    return 0


def register_h5_filter() -> bool:
    """Register the native filter plugin into h5py's HDF5, so plain h5py
    reads and writes of deltarice datasets go through the standard filter
    pipeline. Returns True on success."""
    from .native import register_with_h5py

    return register_with_h5py()
