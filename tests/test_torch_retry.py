"""Per-chunk failure recovery through the port, on the CPU: the port of
``tests/test_retry.py``. Fault injection corrupts the framed output of the
port's encoder (``deltarice_tpu_torch.codec.frame_stream``) for selected
calls; round-trip verification must repair the fault or report it with a
``RuntimeError``. Every stream the port returns must equal the JAX
package's ``compress_batch`` byte for byte (and native ``dr_compress``
where the JAX encode would take long). The card runs the same faults in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest

import deltarice_tpu as drt
import deltarice_tpu.codec as jcodec
import deltarice_tpu_torch as dt
from deltarice_tpu_torch import codec
from deltarice_tpu_torch import h5 as th5
from deltarice_tpu_torch.native import native_compress
from deltarice_tpu_torch.tools.memstore import MemGroup
import hostile_cases as hc

CPU = "cpu"


def _chunks(n=5, shape=(4, 256), seed=0):
    rng = np.random.default_rng(seed)
    return [np.round(np.cumsum(rng.normal(0, 10, shape), axis=-1)).astype(
        np.int16) for _ in range(n)]


def _cfg(cd):
    return dt.RiceConfig.from_cd_values(cd), drt.RiceConfig.from_cd_values(cd)


def test_verify_passes_clean_batch():
    chunks = _chunks()
    cfg, jcfg = _cfg((8, 256))
    got = dt.compress_batch(chunks, cfg, verify=True, device=CPU)
    assert got == dt.compress_batch(chunks, cfg, device=CPU)
    assert got == [bytes(s) for s in jcodec.compress_batch(chunks, jcfg)]


def test_transient_fault_recovers_per_chunk(monkeypatch):
    chunks = _chunks()
    cfg, jcfg = _cfg((8, 256))
    want = [bytes(s) for s in jcodec.compress_batch(chunks, jcfg)]
    # the batch frames each chunk once: corrupt chunk 2 of the first batch;
    # the re-encode (call 5) runs clean
    spy = hc.faulty_frames({2}, codec.frame_stream)
    monkeypatch.setattr(codec, "frame_stream", spy)
    got = dt.compress_batch(chunks, cfg, verify=True, device=CPU)
    assert got == want
    assert spy.count[0] == 6
    for blob, x in zip(got, chunks):
        np.testing.assert_array_equal(
            dt.decompress(blob, cfg, device=CPU).reshape(x.shape), x)


def test_persistent_fault_raises(monkeypatch):
    chunks = _chunks(3)
    cfg, _jcfg = _cfg((8, 256))
    monkeypatch.setattr(codec, "frame_stream",
                        hc.faulty_frames(set(range(100)), codec.frame_stream))
    with pytest.raises(RuntimeError, match="round-trip verification"):
        dt.compress_batch(chunks, cfg, verify=True, retries=2, device=CPU)


def test_write_dataset_verify_flag():
    x = np.vstack(_chunks(2, (4, 128), seed=3))
    cfg, _jcfg = _cfg((8, 128))
    g = MemGroup()
    th5.write_dataset(g, "d", x, cfg, chunks=(4, 128), verify=True,
                      device=CPU)
    np.testing.assert_array_equal(th5.read_dataset(g["d"], device=CPU), x)


def test_header_corruption_recovers(monkeypatch):
    """A fault that breaks a stream's framing (not just payload bits) is
    isolated to its chunk: the batch decode raises, the stream-by-stream
    check finds the one chunk, and it is repaired."""
    chunks = _chunks(4, (2, 128), seed=7)
    cfg, jcfg = _cfg((8, 128))
    want = [bytes(s) for s in jcodec.compress_batch(chunks, jcfg)]
    monkeypatch.setattr(codec, "frame_stream",
                        hc.faulty_frames({1}, codec.frame_stream, "header"))
    seen = []
    real = codec.decompress

    def spy(stream, c, device):
        seen.append(len(stream))
        return real(stream, c, device)

    monkeypatch.setattr(codec, "decompress", spy)
    got = dt.compress_batch(chunks, cfg, verify=True, device=CPU)
    assert got == want
    assert 6 in seen  # the fallback decoded the cut stream on its own


@pytest.mark.parametrize("fault", ["payload", "header"])
def test_split_chunk_fault_recovers_through_the_host_merge(fault,
                                                           monkeypatch):
    """A long-segment chunk at the smallest shape the sub-block split
    takes (one segment of 16384 samples, two sub-blocks merged on the
    host): the re-encode goes through the split encode and its merge
    again."""
    x = np.round(np.cumsum(np.random.default_rng(9).normal(0, 6, 16384))
                 ).astype(np.int16)
    chunks = [x, x[::-1].copy()]
    cd = (8, 16384)
    cfg, _jcfg = _cfg(cd)
    nseg, length, _nv = codec._segment_layout(x.size, cfg)
    assert codec._split_parts(nseg, length, cfg) == 2
    want = [native_compress(c, cd) for c in chunks]
    spy = hc.faulty_frames({0}, codec.frame_stream, fault)
    monkeypatch.setattr(codec, "frame_stream", spy)
    merges = []
    real_merge = codec.merge_substreams

    def merge_spy(*a):
        merges.append(a[0].shape)
        return real_merge(*a)

    monkeypatch.setattr(codec, "merge_substreams", merge_spy)
    got = dt.compress_batch(chunks, cfg, verify=True, device=CPU)
    assert got == want
    assert spy.count[0] == 3  # two chunks, then chunk 0 again
    assert merges == [(2, 2, merges[0][2]), (1, 2, merges[1][2])]


@pytest.mark.parametrize("fault", ["payload", "header"])
def test_write_dataset_verify_repairs_a_window(fault, monkeypatch):
    """Three windows of two chunks; the first chunk framed in the second
    window is damaged once. Its re-encode repairs it before the window is
    written, and every stored blob equals native ``dr_compress`` of its
    chunk."""
    x = np.vstack(_chunks(6, (4, 200), seed=11))
    cd = (8, 200)
    cfg, _jcfg = _cfg(cd)
    spy = hc.faulty_frames({2}, codec.frame_stream, fault)
    monkeypatch.setattr(codec, "frame_stream", spy)
    g = MemGroup()
    th5.write_dataset(g, "d", x, cfg, chunks=(4, 200), batch_chunks=2,
                      verify=True, device=CPU)
    assert spy.count[0] == 7
    dset = g["d"]
    for i in range(6):
        _mask, blob = dset.id.read_direct_chunk((4 * i, 0))
        assert blob == native_compress(x[4 * i : 4 * i + 4], cd), i
    monkeypatch.undo()
    np.testing.assert_array_equal(th5.read_dataset(dset, device=CPU), x)
