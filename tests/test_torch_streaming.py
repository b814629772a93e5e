"""The port's streaming contract (``deltarice_tpu_torch.h5``'s windows of
chunks) against the JAX package's, on the CPU, and at full scale on the
card.

The CPU tests are the counterparts of ``tests/test_streaming.py``'s four
fast tests, on the same shapes, seeds, chunks and windows: the same
numpy-seeded input goes through ``deltarice_tpu.h5`` and through the port's
``h5`` with ``device="cpu"`` (the kernels' plain versions), and stored
blobs must be byte-identical and samples equal (tolerance 0: the codec is
integer and lossless). Then the window bound, counted instead of read off
the resident set: how many source blocks the write holds, and how far the
read runs ahead of what it has handed back, each the same at 4 windows as
at 16.

The card tests (``cuda``; ``slow``, and run only with
``DELTARICE_BIG_TESTS=1``) stream about 1 GB of Nab through the default
window with the resident set measured, and one window of 72 NOPTREX chunks,
2.304e9 bytes, past 2^31. The JAX package and h5py are imported by the
tests that use them, so the card's machine (which has neither) collects
this file.
"""

import gc
import os

import numpy as np
import pytest
import torch

from deltarice_tpu_torch import codec
from deltarice_tpu_torch import h5 as th5
from deltarice_tpu_torch.config import RiceConfig
from deltarice_tpu_torch.models import get_profile
from deltarice_tpu_torch.testing.streaming import (
    SyntheticRows,
    WatchedGroup,
    WindowMeter,
    proc_status,
)
from deltarice_tpu_torch.tools.memstore import MemGroup

BIG = pytest.mark.skipif(os.environ.get("DELTARICE_BIG_TESTS") != "1",
                         reason="gigabytes on the card; set "
                                "DELTARICE_BIG_TESTS=1")


@pytest.fixture
def h5py():
    return pytest.importorskip("h5py")


@pytest.fixture
def jh5():
    return pytest.importorskip("deltarice_tpu.h5")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _data(shape, seed=0):
    rng = np.random.default_rng(seed)
    return np.round(np.cumsum(rng.normal(0, 10, shape),
                              axis=-1)).astype(np.int16)


def _jax_cfg(cfg: RiceConfig):
    import deltarice_tpu as drt

    return drt.RiceConfig(cfg.m, cfg.waveform_length, cfg.filt)


def _blobs(h5py, path, rows, step):
    with h5py.File(path, "r") as f:
        return [f["d"].id.read_direct_chunk((r, 0))[1]
                for r in range(0, rows, step)]


def test_windowed_write_matches_single_window(tmp_path, h5py, jh5):
    """Windows of 3 and of 1000 chunks store the same bytes, and the JAX
    package's windows store them too: the window is an execution detail."""
    x = _data((40, 300), seed=1)
    cfg = RiceConfig(8, 300)
    got = {}
    for bc in (3, 1000):
        with h5py.File(tmp_path / f"t{bc}.h5", "w") as f:
            th5.write_dataset(f, "d", x, cfg, chunks=(4, 300),
                              batch_chunks=bc, device="cpu")
        with h5py.File(tmp_path / f"j{bc}.h5", "w") as f:
            jh5.write_dataset(f, "d", x, _jax_cfg(cfg), chunks=(4, 300),
                              batch_chunks=bc)
        got[bc] = _blobs(h5py, tmp_path / f"t{bc}.h5", 40, 4)
        assert got[bc] == _blobs(h5py, tmp_path / f"j{bc}.h5", 40, 4)
    assert len(got[3]) == 10
    assert got[3] == got[1000]


def test_windowed_read_roundtrip(tmp_path, h5py, jh5):
    x = _data((37, 256), seed=2)  # edge chunks too
    cfg = RiceConfig(8, 256)
    with h5py.File(tmp_path / "t.h5", "w") as f:
        th5.write_dataset(f, "d", x, cfg, chunks=(8, 256), batch_chunks=2,
                          device="cpu")
    with h5py.File(tmp_path / "t.h5", "r") as f:
        got = th5.read_dataset(f["d"], batch_chunks=3, device="cpu")
        want = jh5.read_dataset(f["d"], batch_chunks=3)
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(got, want)


class _Recorded:
    """An open h5py dataset through the surface ``write_dataset`` uses
    (``shape``, ``dtype``, slicing): records every selection asked for and
    refuses to become one array."""

    def __init__(self, dset):
        self._dset = dset
        self.shape, self.dtype, self.ndim = dset.shape, dset.dtype, dset.ndim
        self.requests = []

    def __getitem__(self, sel):
        self.requests.append(sel)
        return self._dset[sel]

    def __array__(self, *args, **kwargs):
        raise AssertionError("the source dataset was materialised")


def test_write_streams_from_h5py_dataset(tmp_path, h5py, jh5):
    """``write_dataset`` takes an open h5py dataset as its source and asks
    it for one chunk's rows at a time, never for the whole dataset; the
    blobs equal the JAX package's from the same source."""
    x = _data((24, 200), seed=3)
    with h5py.File(tmp_path / "src.h5", "w") as f:
        f.create_dataset("raw", data=x)
    cfg = RiceConfig(8, 200)
    with h5py.File(tmp_path / "src.h5", "r") as fs:
        src = _Recorded(fs["raw"])
        with h5py.File(tmp_path / "t.h5", "w") as fd:
            th5.write_dataset(fd, "d", src, cfg, chunks=(8, 200),
                              batch_chunks=1, device="cpu")
        with h5py.File(tmp_path / "j.h5", "w") as fd:
            jh5.write_dataset(fd, "d", fs["raw"], _jax_cfg(cfg),
                              chunks=(8, 200), batch_chunks=1)
    assert [(rs.start, rs.stop, cs.start, cs.stop)
            for rs, cs in src.requests] == [(r, r + 8, 0, 200)
                                            for r in range(0, 24, 8)]
    assert _blobs(h5py, tmp_path / "t.h5", 24, 8) == _blobs(
        h5py, tmp_path / "j.h5", 24, 8)
    with h5py.File(tmp_path / "t.h5", "r") as f:
        np.testing.assert_array_equal(th5.read_dataset(f["d"], device="cpu"),
                                      x)


def test_iter_chunks_yields_every_chunk(tmp_path, h5py, jh5):
    x = _data((16, 128), seed=4)
    cfg = RiceConfig(8, 128)
    with h5py.File(tmp_path / "t.h5", "w") as f:
        th5.write_dataset(f, "d", x, cfg, chunks=(4, 128), device="cpu")
    with h5py.File(tmp_path / "t.h5", "r") as f:
        got = list(th5.iter_chunks(f["d"], batch_chunks=2, device="cpu"))
        want = list(jh5.iter_chunks(f["d"], batch_chunks=2))
    assert [off for off, _ in got] == [(r, 0) for r in range(0, 16, 4)]
    assert [off for off, _ in got] == [off for off, _ in want]
    for (off, block), (_, jblock) in zip(got, want):
        np.testing.assert_array_equal(block, x[off[0]: off[0] + 4])
        np.testing.assert_array_equal(block, jblock)


# the window-bound tests: (8, 64) chunks of a source made on demand
BOUND_ROWS, BOUND_LEN = 8, 64


def _bound_source(windows, batch):
    return SyntheticRows(_data((BOUND_ROWS, BOUND_LEN), seed=6),
                         windows * batch * BOUND_ROWS)


@pytest.mark.parametrize("batch", [1, 3, 5])
def test_write_holds_under_two_windows_of_source_blocks(batch):
    """The bound that ``h5.write_dataset`` gives: window i's blocks are
    read while window i-1's dispatch handle still holds its blocks (the
    codec keeps views of them until that window is collected, which comes
    after window i is dispatched), so at a request the source has handed
    out at most ``batch`` blocks of window i-1 and ``batch - 1`` of window
    i that something still holds: ``2 * batch - 1``. The bound is reached,
    is the same at 4 windows as at 16, and no block outlives the write."""
    cfg = RiceConfig(8, BOUND_LEN)
    held = {}
    for windows in (4, 16):
        src = _bound_source(windows, batch)
        store = MemGroup()
        th5.write_dataset(store, "d", src, cfg, (BOUND_ROWS, BOUND_LEN),
                          batch_chunks=batch, device="cpu")
        assert len(src.requests) == windows * batch
        assert src.live() == 0
        held[windows] = max(src.live_at_request)
        for off, (_mask, blob) in store["d"].id.chunks.items():
            assert blob == codec.compress(
                src.block(off[0], off[0] + BOUND_ROWS), cfg, device="cpu")
    assert held[4] == held[16] == 2 * batch - 1


@pytest.mark.parametrize("batch", [1, 3, 5])
def test_read_runs_at_most_two_windows_ahead(batch):
    """The bound that ``h5.iter_chunks`` gives: it reads and dispatches
    window i before it hands back window i-1's chunks, so when it yields a
    chunk it has read at most two windows past the chunks it yielded
    before: ``2 * batch`` raw streams. The bound is reached and is the same
    at 4 windows as at 16."""
    cfg = RiceConfig(8, BOUND_LEN)
    ahead = {}
    for windows in (4, 16):
        src = _bound_source(windows, batch)
        store = MemGroup()
        dset = th5.write_dataset(store, "d", src, cfg,
                                 (BOUND_ROWS, BOUND_LEN), batch_chunks=batch,
                                 device="cpu")
        reads = []
        read = dset.id.read_direct_chunk

        def counted(offset, _read=read):
            reads.append(offset)
            return _read(offset)

        dset.id.read_direct_chunk = counted
        gaps = []
        for n, (off, block) in enumerate(th5.iter_chunks(
                dset, batch_chunks=batch, device="cpu")):
            gaps.append(len(reads) - n)
            np.testing.assert_array_equal(
                block, src.block(off[0], off[0] + BOUND_ROWS))
        assert n + 1 == len(reads) == windows * batch
        ahead[windows] = max(gaps)
    assert ahead[4] == ahead[16] == 2 * batch


def test_watched_group_calls_back_after_each_chunk():
    """``WatchedGroup`` calls back after every chunk is stored, with the
    chunks and the blob bytes stored so far."""
    calls = []
    store = WatchedGroup(lambda n, stored: calls.append((n, stored)))
    src = SyntheticRows(_data((8, 64), seed=7), 8 * 7)
    dset = th5.write_dataset(store, "d", src, RiceConfig(8, 64), (8, 64),
                             batch_chunks=3, device="cpu")
    sizes = [len(dset.id.chunks[(r, 0)][1]) for r in range(0, 56, 8)]
    assert calls == [(n + 1, sum(sizes[: n + 1])) for n in range(7)]


def test_synthetic_rows_match_the_jax_source():
    """The gigabyte source: on the JAX test's base rows, every block equals
    that test's ``_SyntheticSource``'s (base rows plus the block's first
    row modulo 251, wrapping in int16); a block longer than the base is
    refused."""
    jsrc = pytest.importorskip("test_streaming")._SyntheticSource(1000, 50)
    src = SyntheticRows(jsrc._base, 1000)
    for r0, r1 in ((0, 32), (640, 672), (250, 251), (992, 1000)):
        sel = (slice(r0, r1), slice(0, 50))
        np.testing.assert_array_equal(src[sel], jsrc[sel])
        np.testing.assert_array_equal(src.block(r0, r1), jsrc[sel])
    with pytest.raises(ValueError):
        src.block(0, 33)


@pytest.mark.parametrize("hwm", [True, False])
def test_window_meter_on_the_cpu(monkeypatch, hwm):
    """A CPU meter samples the resident set at each window's end: RSS less
    blobs is RSS less the stored bytes, and the window's peak holds a
    block freed before the window ended, through ``VmHWM`` or, where the
    kernel gives none, through the ticks."""
    from deltarice_tpu_torch.testing import streaming

    if not hwm:
        status = streaming.proc_status
        monkeypatch.setattr(streaming, "proc_status",
                            lambda: {"VmRSS": status()["VmRSS"]})
    gc.collect()  # no collection frees earlier tests' memory in between
    meter = WindowMeter("cpu")
    first = meter.start()
    held = np.ones(32 << 20, np.uint8)  # 32 MiB, touched
    meter.tick(0)
    del held
    s = meter.window(1000)
    assert meter.hwm_reset == (hwm and streaming.reset_peak_rss())
    assert first["blobs"] == 0 and first["wall_s"] == 0.0
    assert s["rss_less_blobs"] == s["rss"] - 1000
    assert s["wall_s"] > 0 and "pinned" not in s
    assert s["peak_less_blobs"] >= first["rss_less_blobs"] + (30 << 20)
    assert len(meter.samples) == 2
    st = proc_status()
    assert st["VmRSS"] > 0 and st.get("VmHWM", st["VmRSS"]) >= st["VmRSS"]


# --- on the card ------------------------------------------------------------

NAB_ROWS, NAB_LEN = 72000, 7000
WARM = 2  # windows before the no-growth reference
# the peak RSS after warm-up less blobs, above the RSS before the stream, in
# windows of raw bytes
RSS_PEAK_WINDOWS = 8


def _peaks(samples, window):
    """(growth of RSS less blobs after window WARM, peak after warm-up
    above the start), in windows."""
    after = samples[WARM + 1:]
    growth = max(s["rss_less_blobs"] for s in after) - samples[WARM][
        "rss_less_blobs"]
    peak = max(s["peak_less_blobs"] for s in after) - samples[0][
        "rss_less_blobs"]
    return growth / window, peak / window


@BIG
@pytest.mark.slow
@pytest.mark.cuda
def test_gigabyte_roundtrip_constant_memory(cuda):
    """About 1 GB of Nab (72000 x 7000, made on demand as the JAX test
    makes it) through ``write_dataset`` and ``iter_chunks`` at the default
    window of 64 chunks (28.7 MB), every chunk compared, after a warm-up
    stream of two windows. After the stream's first two windows, RSS less
    the stored blobs grows by at most one window, and its peak from there
    on stays within ``RSS_PEAK_WINDOWS`` windows of the RSS before the
    stream: not the dataset's size (35 windows)."""
    batch = th5.DEFAULT_BATCH_CHUNKS
    window = batch * 32 * NAB_LEN * 2
    cfg = RiceConfig(8, NAB_LEN)
    src = SyntheticRows(_data((32, NAB_LEN), seed=5), NAB_ROWS)
    # the process's one-time costs (the kernels' modules, first pinned
    # blocks) are paid on two windows before the measured stream
    warm = th5.write_dataset(MemGroup(), "w", SyntheticRows(
        src.base, 2 * batch * 32), cfg, chunks=(32, NAB_LEN), device="cuda")
    for _ in th5.iter_chunks(warm, device="cuda"):
        pass
    meter = WindowMeter("cuda")
    nchunks = NAB_ROWS // 32

    def on_write(n, stored):
        meter.tick(stored)
        if n % batch == 0 or n == nchunks:
            meter.window(stored)

    store = WatchedGroup(on_write)
    meter.start()
    dset = th5.write_dataset(store, "d", src, cfg, chunks=(32, NAB_LEN),
                             device="cuda")
    written = meter.samples
    stored = dset.id.get_storage_size()
    assert stored < NAB_ROWS * NAB_LEN  # < 50% of raw
    meter.start(stored)
    seen = 0
    for off, block in th5.iter_chunks(dset, device="cuda"):
        np.testing.assert_array_equal(block, src.block(off[0], off[0] + 32))
        seen += 1
        meter.tick(stored)
        if seen % batch == 0 or seen == nchunks:
            meter.window(stored)
    assert seen == nchunks
    for what, samples in (("write", written), ("read", meter.samples)):
        assert len(samples) == 1 + -(-seen // batch)
        growth, peak = _peaks(samples, window)
        print(f"{what}: RSS less blobs grew {growth:.3f} windows after "
              f"window {WARM}, peak {peak:.3f} windows above the start "
              f"(VmHWM reset: {meter.hwm_reset})")
        assert growth <= 1.0, what
        assert peak <= RSS_PEAK_WINDOWS, what


@BIG
@pytest.mark.slow
@pytest.mark.cuda
def test_a_window_past_2_31_bytes_round_trips(cuda):
    """One window of 72 NOPTREX chunks of (32, 500000): 2.304e9 bytes of
    int16 in one batch, past 2^31. It round-trips exactly through
    ``write_dataset`` / ``iter_chunks`` on a store in memory, and the first
    and last blobs equal native ``dr_compress``."""
    from deltarice_tpu_torch.native import native_compress

    prof = get_profile("noptrex")
    cfg, length, batch = prof.config, prof.waveform_length, 72
    assert batch * 32 * length * 2 > 1 << 31
    src = SyntheticRows(prof.synthetic(32, seed=0), batch * 32)
    dset = th5.write_dataset(MemGroup(), "d", src, cfg, (32, length),
                             batch_chunks=batch, device="cuda")
    for r0 in (0, (batch - 1) * 32):
        assert dset.id.read_direct_chunk((r0, 0)) == (0, native_compress(
            src.block(r0, r0 + 32), cfg.to_cd_values()))
    seen = 0
    for off, block in th5.iter_chunks(dset, batch_chunks=batch,
                                      device="cuda"):
        assert off == (seen * 32, 0)
        assert np.array_equal(block, src.block(off[0], off[0] + 32))
        seen += 1
    assert seen == batch
