"""The h5 streaming contract, measured: an on-demand row source, a store
that marks the end of each written window, and the memory a process holds
at each window's end.

* :class:`SyntheticRows` is an array-like dataset that makes each block of
  rows when asked for it, from a few base rows plus the block's first row
  modulo 251 (the JAX package's gigabyte streaming test builds its source
  the same way), so a dataset of any size streams without ever being held.
  It keeps a weak reference to every block it hands out: :meth:`live`
  counts the blocks something still holds, and ``live_at_request`` records
  that count at every request.
* :class:`WatchedGroup` is a :class:`~..tools.memstore.MemGroup` whose
  datasets call back after each chunk is stored.
* :class:`WindowMeter` samples, at each window's end, the process's
  resident set (``VmRSS`` in ``/proc/self/status``) and its peak over the
  window (``VmHWM``, reset through ``/proc/self/clear_refs``, or where the
  kernel has neither, the largest ``VmRSS`` read between window ends), the
  caching host allocator's pinned bytes and the device allocator's bytes,
  and the window's wall time.

None of it is on a codec path; it drives ``h5`` as a user does.
"""

from __future__ import annotations

import time
import weakref
from pathlib import Path

import numpy as np
import torch

from ..tools.memstore import MemGroup

STATUS = Path("/proc/self/status")
CLEAR_REFS = Path("/proc/self/clear_refs")
MEMINFO = Path("/proc/meminfo")


class SyntheticRows:
    """(rows, L) int16 made on demand: rows ``[r0, r1)`` are
    ``base[:r1 - r0] + r0 % 251`` (int16, wrapping), so a block may span
    at most ``len(base)`` rows. Records every selection it is asked for in
    ``requests``."""

    def __init__(self, base: np.ndarray, rows: int):
        self.base = np.ascontiguousarray(base, dtype=np.int16)
        self.shape = (int(rows), self.base.shape[1])
        self.dtype = self.base.dtype
        self.ndim = 2
        self.requests: list[tuple] = []
        self.live_at_request: list[int] = []
        self._handed: list[weakref.ref] = []

    def live(self) -> int:
        """Blocks handed out that something still holds."""
        self._handed = [r for r in self._handed if r() is not None]
        return len(self._handed)

    def block(self, r0: int, r1: int, cols=slice(None)) -> np.ndarray:
        """Rows ``[r0, r1)``, untracked (what a reader compares with)."""
        if not 0 <= r0 <= r1 <= self.shape[0]:
            raise IndexError(f"rows [{r0}, {r1}) outside {self.shape[0]}")
        if r1 - r0 > self.base.shape[0]:
            raise ValueError(f"a block spans at most {self.base.shape[0]} "
                             f"rows; asked for {r1 - r0}")
        out = self.base[: r1 - r0, cols].copy()
        out += np.int16(r0 % 251)
        return out

    def __getitem__(self, sel):
        rs, cs = sel
        self.requests.append(sel)
        self.live_at_request.append(self.live())
        out = self.block(rs.start, min(rs.stop, self.shape[0]), cs)
        self._handed.append(weakref.ref(out))
        return out


class WatchedGroup(MemGroup):
    """A :class:`MemGroup` whose datasets call ``on_write(count,
    stored_bytes)`` after each chunk is stored: the chunks and the blob
    bytes stored so far."""

    def __init__(self, on_write):
        super().__init__()
        self.on_write = on_write

    def create_dataset(self, name, shape, dtype, chunks, compression,
                       compression_opts, allow_unknown_filter=False):
        dset = super().create_dataset(name, shape, dtype, chunks, compression,
                                      compression_opts, allow_unknown_filter)
        store, written = dset.id.write_direct_chunk, [0, 0]

        def write(offset, data, filter_mask=0):
            store(offset, data, filter_mask)
            written[0] += 1
            written[1] += len(data)
            self.on_write(*written)

        dset.id.write_direct_chunk = write
        return dset


def _kib_fields(path: Path, keys) -> dict[str, int]:
    """The ``key: N kB`` fields of a ``/proc`` file that it has, in
    bytes."""
    out = {}
    for line in path.read_text().splitlines():
        key, _, value = line.partition(":")
        if key in keys:
            out[key] = int(value.split()[0]) * 1024
    return out


def proc_status() -> dict[str, int]:
    """``VmRSS`` and ``VmHWM`` of this process, in bytes, where the kernel
    gives them (some kernels, gVisor's for one, give no ``VmHWM``)."""
    return _kib_fields(STATUS, ("VmRSS", "VmHWM"))


def meminfo() -> dict[str, int]:
    """``MemTotal`` and ``MemAvailable`` of the machine, in bytes."""
    return _kib_fields(MEMINFO, ("MemTotal", "MemAvailable"))


def reset_peak_rss() -> bool:
    """Set ``VmHWM`` back to the current RSS (``5`` into
    ``/proc/self/clear_refs``); False where the kernel refuses."""
    try:
        CLEAR_REFS.write_text("5")
    except OSError:
        return False
    return True


def pinned_stats() -> dict[str, int | None]:
    """The caching host allocator's pinned bytes, current and peak (None
    where this torch reports none): ``reserved``, the blocks it owns,
    cached ones included (``allocated_bytes`` in
    ``torch.cuda.host_memory_stats()``), and ``active``, those handed out
    (``active_bytes``; torch 2.11 does not count back a block freed behind
    a stream's event, so this one only grows)."""
    stats = torch.cuda.host_memory_stats()
    return {f"{label}.{kind}": stats.get(f"{key}.{kind}")
            for label, key in (("reserved", "allocated_bytes"),
                               ("active", "active_bytes"))
            for kind in ("current", "peak")}


def empty_caches() -> None:
    """Give the device allocator's and the host allocator's cached blocks
    back to CUDA, where this torch has a call for each."""
    torch.cuda.empty_cache()
    for owner, name in ((getattr(torch, "accelerator", None),
                         "empty_host_cache"),
                        (torch._C, "_host_emptyCache")):
        fn = getattr(owner, name, None)
        if fn is not None:
            fn()
            return


class WindowMeter:
    """Memory and wall time at the end of each window of a stream.

    :meth:`start` empties the allocators' caches (on a CUDA device), resets
    their peaks and ``VmHWM``, and takes the first sample; :meth:`tick`
    reads ``VmRSS`` between window ends (after each chunk, say); each
    :meth:`window` call takes a sample and resets the peaks again. A
    sample's ``rss_less_blobs`` is ``VmRSS`` less the stored blob bytes.
    Its ``peak_less_blobs`` bounds RSS less blobs over the window from
    above: ``VmHWM`` (the peak since the previous sample) less the blob
    bytes stored at the previous sample, since blobs only accumulate; where
    the kernel gives no ``VmHWM`` or refuses to reset it (``hwm_reset``
    False), the largest RSS less blobs of the window's ticks and its end
    instead."""

    def __init__(self, device="cuda"):
        self.cuda = torch.device(device).type == "cuda"
        self.samples: list[dict] = []
        self.hwm_reset = False
        self._t = 0.0
        self._blobs = 0
        self._peak = None

    def start(self, blob_bytes: int = 0) -> dict:
        if self.cuda:
            torch.cuda.synchronize()
            empty_caches()
        self.samples = []
        self.hwm_reset = False
        self._peak = None
        return self._sample(blob_bytes)

    def tick(self, blob_bytes: int) -> None:
        rss = proc_status()["VmRSS"] - blob_bytes
        self._peak = rss if self._peak is None else max(self._peak, rss)

    def window(self, blob_bytes: int) -> dict:
        return self._sample(blob_bytes)

    def _sample(self, blob_bytes: int) -> dict:
        now = time.perf_counter()
        st = proc_status()
        s = {"wall_s": now - self._t if self.samples else 0.0,
             "rss": st["VmRSS"], "hwm": st.get("VmHWM"),
             "blobs": blob_bytes, "rss_less_blobs": st["VmRSS"] - blob_bytes}
        if self.hwm_reset:
            s["peak_less_blobs"] = st["VmHWM"] - self._blobs
        else:
            s["peak_less_blobs"] = max(s["rss_less_blobs"],
                                       self._peak or s["rss_less_blobs"])
        if self.cuda:
            s["pinned"] = pinned_stats()
            s["device"] = {"allocated": torch.cuda.memory_allocated(),
                           "reserved": torch.cuda.memory_reserved(),
                           "max_allocated": torch.cuda.max_memory_allocated(),
                           "max_reserved": torch.cuda.max_memory_reserved()}
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.reset_peak_host_memory_stats()
        self.hwm_reset = "VmHWM" in st and reset_peak_rss()
        self.samples.append(s)
        self._blobs = blob_bytes
        self._peak = None
        self._t = time.perf_counter()
        return s
