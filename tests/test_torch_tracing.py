"""The port's tracer (``deltarice_tpu_torch.tracing``) on the CPU: off by
default and then free of records, profiler calls and CUDA events; on inside
``recording()`` and under a ``torch.profiler``, with the span tree of the
codec entry, the op wrappers, the batch path and the h5 windows; self time,
the ring's bound, the counters, and outputs equal with tracing on and off.
The wrappers' allocation, launch and device-event spans run here against a
stand-in library and stand-in events (``fake_card``); the real events are
held to the profiler's kernel time in ``tests/test_torch_cuda.py``.
Imports no JAX.
"""

import threading
import time

import numpy as np
import pytest
import torch

import deltarice_tpu_torch as dt
from deltarice_tpu_torch import codec, tracing
from deltarice_tpu_torch import h5 as th5
from deltarice_tpu_torch.ops import _kernels
from deltarice_tpu_torch.tools.memstore import MemGroup
import hostile_cases as hc

CPU = "cpu"
L = 700


@pytest.fixture(autouse=True)
def clean():
    tracing.clear()
    yield
    tracing.clear()


def _rows(n=6, length=L, seed=0):
    rng = np.random.default_rng(seed)
    return np.round(np.cumsum(rng.normal(0, 10, (n, length)), axis=1)).astype(
        np.int16)


def _tree(snap):
    """(name, parent's name) of every span, in order."""
    spans = snap["spans"]
    by_call = {}
    for s in spans:
        by_call.setdefault(s["call"], []).append(s)
    out = []
    for s in spans:
        call = by_call[s["call"]]
        out.append((s["name"], None if s["parent"] is None
                    else call[s["parent"]]["name"]))
    return out


class FakeEvent:
    """A CUDA timing event's surface; every pair reads 1.5 ms."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.recorded = False

    def record(self, stream=None):
        self.recorded = True

    def synchronize(self):
        assert self.recorded

    def elapsed_time(self, end):
        assert self.recorded and end.recorded
        return 1.5


class FakeLib:
    """The kernels' library: sizes, and launches that write nothing."""

    def dr_pack_scratch_words(self, length, nseg):
        return 8

    def dr_unpack_scratch_bytes(self, w, nseg):
        return 8

    def dr_pack_encode(self, *args):
        return 0

    def dr_unpack_decode(self, *args):
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors take the wrappers' kernel path, against FakeLib, and
    device events are FakeEvents."""
    monkeypatch.setattr(_kernels, "route", lambda t: True)
    monkeypatch.setattr(_kernels, "library", lambda: FakeLib())
    monkeypatch.setattr(_kernels, "stream", lambda: 0)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    FakeEvent.made = 0
    _kernels.reset_launches()
    yield
    _kernels.reset_launches()


def _refuse(*args, **kwargs):
    raise AssertionError("called with tracing off")


@pytest.mark.parametrize("path", ["plain", "fake_card"])
def test_off_by_default_records_nothing(path, monkeypatch, request):
    if path == "fake_card":
        request.getfixturevalue("fake_card")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(tracing, "_RecordFunctionFast", _refuse)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    monkeypatch.setattr(tracing, "Span", _refuse)
    monkeypatch.setattr(tracing, "_Device", _refuse)
    assert not tracing.on()
    cfg = dt.RiceConfig(8, L)
    x = _rows()
    words, counts = dt.encode_segments(x, np.full(6, L, np.int32), cfg, 512,
                                       device=CPU)
    dt.decode_segments(words, L, cfg, device=CPU)
    if path == "plain":
        dt.decompress_batch(dt.compress_batch([x], cfg, device=CPU), cfg,
                            device=CPU)
    snap = tracing.snapshot()
    assert snap["spans"] == []
    assert snap["counters"]["rows_encoded"] == (12 if path == "plain" else 6)
    null = tracing.span("encode_segments", rows=6, length=L, words=512)
    assert null is tracing.span("h5.read_window") is tracing._NULL
    assert tracing.device("fill") is tracing._NULL
    with null as sp:
        assert sp is None


def test_recording_nests_and_turns_off_again():
    assert not tracing.on()
    with tracing.recording():
        with tracing.recording():
            assert tracing.on()
        assert tracing.on()
    assert not tracing.on()
    with pytest.raises(KeyError):
        with tracing.recording():
            raise KeyError
    assert not tracing.on()


def test_encode_span_tree():
    cfg = dt.RiceConfig(8, L)
    with tracing.recording():
        for _ in range(2):
            dt.encode_segments(_rows(), np.full(6, L, np.int32), cfg, 512,
                               device=CPU)
    snap = tracing.snapshot()
    assert _tree(snap) == [("dr.encode_segments", None),
                           ("dr.stage", "dr.encode_segments"),
                           ("dr.pack_encode", "dr.encode_segments")] * 2
    spans = snap["spans"]
    assert [s["call"] for s in spans[:3]] == [spans[0]["call"]] * 3
    assert spans[3]["call"] != spans[0]["call"]
    top = spans[0]
    assert (top["rows"], top["length"], top["words"]) == (6, L, 512)
    assert spans[2]["words"] == 512
    for s in spans:
        assert s["outer_start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= s["outer_end_ns"]
        assert s["device_ms"] == {}
    for child in spans[1:3]:
        assert top["start_ns"] <= child["start_ns"] <= child["end_ns"] \
            <= top["end_ns"]


def test_generic_filter_spans():
    cfg = dt.RiceConfig(8, L, filt=(1, 0, -1))
    with tracing.recording():
        words, _ = dt.encode_segments(_rows(), np.full(6, L, np.int32), cfg,
                                      cfg.max_words(L), device=CPU)
        dt.decode_segments(words, L, cfg, device=CPU)
    assert _tree(tracing.snapshot()) == [
        ("dr.encode_segments", None), ("dr.stage", "dr.encode_segments"),
        ("dr.prefilter", "dr.encode_segments"),
        ("dr.pack_encode", "dr.encode_segments"),
        ("dr.decode_segments", None), ("dr.stage", "dr.decode_segments"),
        ("dr.unpack_decode", "dr.decode_segments"),
        ("dr.prefilter_inverse", "dr.decode_segments")]


def test_decode_span_tree():
    cfg = dt.RiceConfig(8, L)
    words, _ = dt.encode_segments(_rows(), np.full(6, L, np.int32), cfg, 512,
                                  device=CPU)
    with tracing.recording():
        dt.decode_segments(words, L, cfg, device=CPU)
    snap = tracing.snapshot()
    assert _tree(snap) == [("dr.decode_segments", None),
                           ("dr.stage", "dr.decode_segments"),
                           ("dr.unpack_decode", "dr.decode_segments")]
    top, _stage, wrapper = snap["spans"]
    assert (top["rows"], top["length"], top["words"]) == (6, L, 512)
    assert wrapper["length"] == L
    assert snap["counters"] == {"rows_encoded": 6, "rows_decoded": 6}


def test_a_profiler_turns_tracing_on_and_holds_the_spans():
    from torch.profiler import ProfilerActivity, profile

    cfg = dt.RiceConfig(8, L)
    x = _rows()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.on()
        words, _ = dt.encode_segments(x, np.full(6, L, np.int32), cfg, 512,
                                      device=CPU)
        dt.decode_segments(words, L, cfg, device=CPU)
    assert not tracing.on()
    names = {e.name for e in prof.events()}
    assert {"dr.encode_segments", "dr.stage", "dr.pack_encode",
            "dr.decode_segments", "dr.unpack_decode"} <= names
    assert [n for n, _p in _tree(tracing.snapshot())] == [
        "dr.encode_segments", "dr.stage", "dr.pack_encode",
        "dr.decode_segments", "dr.stage", "dr.unpack_decode"]
    # a profiler's span encloses its children on the profiler's clock too
    ev = {e.name: e for e in prof.events() if e.name.startswith("dr.")}
    top, kid = ev["dr.encode_segments"], ev["dr.pack_encode"]
    assert top.time_range.start <= kid.time_range.start
    assert kid.time_range.end <= top.time_range.end


def test_a_profiler_span_takes_the_cheap_annotation(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    cfg = dt.RiceConfig(8, L)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dt.encode_segments(_rows(), np.full(6, L, np.int32), cfg, 512,
                           device=CPU)
    names = {e.name for e in prof.events()}
    assert {"dr.encode_segments", "dr.stage", "dr.pack_encode"} <= names


def _spans(*intervals):
    """Hand-made records: (start, end, parent index) each."""
    return [{"start_ns": s, "end_ns": e, "parent": p} for s, e, p in intervals]


@pytest.mark.parametrize("spans,want", [
    (_spans((0, 100, None)), 100),
    (_spans((0, 100, None), (10, 30, 0), (50, 60, 0)), 70),
    # overlapping children count once; a grandchild counts for its parent
    (_spans((0, 100, None), (10, 40, 0), (30, 50, 0), (35, 45, 1)), 60),
    # a child past the parent's end counts only inside it
    (_spans((0, 100, None), (90, 130, 0), (-5, 5, 0)), 85),
    (_spans((0, 100, None), (0, 100, 0)), 0),
    # a child's bookkeeping and annotation, outside its own interval, are
    # no part of its parent's self time
    ([{"start_ns": 0, "end_ns": 100, "parent": None,
       "outer_start_ns": -4, "outer_end_ns": 104},
      {"start_ns": 20, "end_ns": 40, "parent": 0,
       "outer_start_ns": 12, "outer_end_ns": 46}], 66),
], ids=["alone", "two", "overlap", "outside", "whole", "outer"])
def test_self_time_of_hand_made_records(spans, want):
    assert tracing.self_ns(spans, 0) == want


def test_self_time_of_a_child_and_calls_by_rows():
    snap = {"spans": [
        {"name": "dr.encode_segments", "call": 1, "parent": None, "rows": 4,
         "start_ns": 0, "end_ns": 100},
        {"name": "dr.pack_encode", "call": 1, "parent": 0, "start_ns": 20,
         "end_ns": 90},
        {"name": "dr.alloc", "call": 1, "parent": 1, "start_ns": 30,
         "end_ns": 40},
        {"name": "dr.encode_segments", "call": 2, "parent": None, "rows": 2,
         "start_ns": 200, "end_ns": 210},
        {"name": "dr.decode_segments", "call": 3, "parent": None, "rows": 4,
         "start_ns": 300, "end_ns": 310}]}
    calls = tracing.calls(snap, "dr.encode_segments", rows=4)
    assert [[s["name"] for s in c] for c in calls] == [
        ["dr.encode_segments", "dr.pack_encode", "dr.alloc"]]
    assert tracing.self_ns(calls[0], 1) == 60
    assert len(tracing.calls(snap, "dr.encode_segments")) == 2
    assert tracing.calls(snap, "dr.encode_segments", rows=3) == []


def _call(ident, rows, end, wrapper_end, tracer_ns, events):
    """Hand-made records of one encode: entry [0, end), wrapper [10,
    wrapper_end) with ``tracer_ns`` of the tracer's own time, and a launch
    span holding ``events``."""
    return [
        {"name": "dr.encode_segments", "call": ident, "parent": None,
         "rows": rows, "start_ns": 0, "end_ns": end, "device_ms": {}},
        {"name": "dr.pack_encode", "call": ident, "parent": 0, "start_ns": 10,
         "end_ns": wrapper_end, "tracer_ns": tracer_ns, "device_ms": {}},
        {"name": "dr.launch", "call": ident, "parent": 1, "start_ns": 20,
         "end_ns": 30, "device_ms": events}]


def test_readers_take_the_median_over_calls_of_the_rows():
    snap = {"spans": _call(1, 4, 100, 90, 30, {"kernels": 2.0})
            + _call(2, 4, 200, 190, 0, {"kernels": 4.0, "fill": 1.0})
            + _call(3, 2, 900, 890, 0, {"kernels": 9.0, "fill": 9.0})}
    top, wrapper = tracing.ENTRY["encode"], tracing.WRAPPER["encode"]
    assert tracing.self_ms(snap, top, 4) == pytest.approx(20e-6)
    assert tracing.host_ms(snap, top, 4, wrapper) == pytest.approx(115e-6)
    assert tracing.event_ms(snap, top, 4, "kernels") == 3.0
    assert tracing.event_ms(snap, top, 4, "fill") == 1.0  # call 2 alone
    assert tracing.event_ms(snap, top, 2, "fill") == 9.0
    for read in (lambda r: tracing.self_ms(snap, top, r),
                 lambda r: tracing.host_ms(snap, top, r, wrapper),
                 lambda r: tracing.event_ms(snap, top, r, "kernels")):
        assert read(3) is None
    assert tracing.host_ms(snap, top, 4, "dr.alloc") is None


def test_tracer_time_is_left_out_of_host_time(fake_card, monkeypatch):
    """A span's ``tracer_ns`` holds its device events' host cost and its
    children's bookkeeping; :func:`host_ns` leaves it out."""
    record = FakeEvent.record

    def slow_record(self, stream=None):
        time.sleep(0.02)
        record(self, stream)

    monkeypatch.setattr(FakeEvent, "record", slow_record)
    cfg = dt.RiceConfig(8, L)
    with tracing.recording():
        dt.encode_segments(torch.from_numpy(_rows()),
                           torch.full((6,), L, dtype=torch.int32), cfg, 512,
                           device=CPU)
    spans = {s["name"]: s for s in tracing.snapshot()["spans"]}
    alloc, launch = spans["dr.alloc"], spans["dr.launch"]
    wrapper, top = spans["dr.pack_encode"], spans["dr.encode_segments"]
    assert alloc["tracer_ns"] >= 40e6 and launch["tracer_ns"] >= 40e6
    assert wrapper["tracer_ns"] >= alloc["tracer_ns"] + launch["tracer_ns"]
    assert top["tracer_ns"] >= wrapper["tracer_ns"]
    for s in (alloc, launch, wrapper, top):
        assert 0 <= tracing.host_ns(s) < 40e6
    assert tracing.host_ns(wrapper) >= (tracing.host_ns(alloc)
                                        + tracing.host_ns(launch))


def test_ring_keeps_the_newest_calls_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "RING", 3)
    with tracing.recording():
        for i in range(5):
            with tracing.span("encode_segments", rows=i):
                with tracing.span("stage"):
                    pass
    snap = tracing.snapshot()
    tops = [s for s in snap["spans"] if s["parent"] is None]
    assert [s["rows"] for s in tops] == [2, 3, 4]
    assert len(snap["spans"]) == 6
    assert snap["counters"]["spans_dropped"] == 2
    tracing.clear()
    assert tracing.snapshot()["spans"] == []
    assert "spans_dropped" not in tracing.snapshot()["counters"]


def test_spans_of_two_threads_keep_their_own_parents():
    seen = {}

    def other():
        with tracing.span("decode_segments"):
            seen["inner"] = True

    with tracing.recording():
        with tracing.span("encode_segments"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive() and seen["inner"]
    assert sorted(_tree(tracing.snapshot())) == [
        ("dr.decode_segments", None), ("dr.encode_segments", None)]


@pytest.mark.parametrize("filt", [(1, -1), (1, 0, -1)], ids=["delta", "fir"])
def test_outputs_equal_with_tracing_on_and_off(filt):
    cfg = dt.RiceConfig(8, L, filt=filt)
    x = _rows(8, seed=3)
    x[5] = np.random.default_rng(4).integers(-32768, 32768, L)
    nv = np.full(8, L, np.int32)
    nv[2] = 333

    def run():
        w, n = dt.encode_segments(x, nv, cfg, 256, device=CPU)
        full, _ = dt.encode_segments(x, nv, cfg, cfg.max_words(L), device=CPU)
        out = dt.decode_segments(full, L, cfg, device=CPU)
        blobs = dt.compress_batch([x[:4], x[4:]], cfg, device=CPU)
        back = dt.decompress_batch(blobs, cfg, device=CPU)
        return w, n, out, blobs, back

    off = run()
    with tracing.recording():
        on = run()
    assert tracing.snapshot()["spans"]
    for a, b in zip(off[:3], on[:3]):
        assert torch.equal(a, b)
    assert off[3] == on[3]
    for a, b in zip(off[4], on[4]):
        np.testing.assert_array_equal(a, b)


def test_wrappers_on_a_fake_card_count_launches_and_time_events(fake_card):
    cfg = dt.RiceConfig(8, L)
    x = torch.from_numpy(_rows())
    nv = torch.full((6,), L, dtype=torch.int32)
    words, _ = dt.encode_segments(x, nv, cfg, 512, device=CPU)
    dt.decode_segments(words, L, cfg, device=CPU)
    assert dict(_kernels.launches) == {"pack_encode": 1, "unpack_decode": 1}
    assert FakeEvent.made == 0
    with tracing.recording():
        words, _ = dt.encode_segments(x, nv, cfg, 512, device=CPU)
        dt.decode_segments(words, L, cfg, device=CPU)
    assert dict(_kernels.launches) == {"pack_encode": 2, "unpack_decode": 2}
    assert FakeEvent.made == 6  # fill, encode's kernels, decode's kernels
    snap = tracing.snapshot()
    assert snap["launches"] == {"pack_encode": 2, "unpack_decode": 2}
    assert _tree(snap) == [
        ("dr.encode_segments", None), ("dr.stage", "dr.encode_segments"),
        ("dr.pack_encode", "dr.encode_segments"),
        ("dr.alloc", "dr.pack_encode"), ("dr.launch", "dr.pack_encode"),
        ("dr.decode_segments", None), ("dr.stage", "dr.decode_segments"),
        ("dr.unpack_decode", "dr.decode_segments"),
        ("dr.alloc", "dr.unpack_decode"), ("dr.launch", "dr.unpack_decode")]
    device = [s["device_ms"] for s in snap["spans"]]
    assert device == [{}, {}, {}, {"fill": 1.5}, {"kernels": 1.5},
                      {}, {}, {}, {}, {"kernels": 1.5}]
    alloc = snap["spans"][3]
    assert (alloc["rows"], alloc["length"], alloc["words"]) == (6, L, 512)
    assert tracing.snapshot() == snap  # resolved once, read again alike


def test_tiles_rejoined_is_read_by_the_snapshot_alone(fake_card,
                                                     monkeypatch):
    """B2's wrapper hands the library a device counter and never reads it
    back: with tracing off and ``Tensor.item`` refused, decodes run while
    the stand-in library adds to the counter; ``snapshot()`` reads the sum
    into ``counters["tiles_rejoined"]``, and ``clear()`` zeroes it."""
    import ctypes

    from deltarice_tpu_torch.ops.unpack_cuda import unpack_decode

    class Counting(FakeLib):
        def dr_unpack_decode(self, *args):
            ctypes.c_int64.from_address(args[9]).value += 5
            return 0

    monkeypatch.setattr(_kernels, "library", lambda: Counting())
    words = torch.zeros((4, 40), dtype=torch.int32)
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "item", _refuse)
        assert not tracing.on()
        for _ in range(3):
            unpack_decode(words, 100, 3)
    assert tracing.counters["tiles_rejoined"] == 0  # nothing read yet
    assert tracing.snapshot()["counters"]["tiles_rejoined"] == 15
    assert tracing.counters["tiles_rejoined"] == 15
    tracing.clear()
    assert "tiles_rejoined" not in tracing.snapshot()["counters"]


def test_no_device_event_outside_a_span_or_in_a_capture(fake_card,
                                                        monkeypatch):
    with tracing.recording():
        assert tracing.device("fill") is tracing._NULL
        with tracing.span("launch"):
            monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                                lambda: True)
            assert tracing.device("kernels") is tracing._NULL
    assert FakeEvent.made == 0


class StubCDLL:
    """A loaded library whose every symbol takes argtypes and restype."""

    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        fn = type("Symbol", (), {})()
        setattr(self, name, fn)
        return fn


def test_build_and_load_spans(monkeypatch, tmp_path):
    built = []

    def compile_library(csrc, flags, lib, verbose=False):
        built.append(lib)
        return lib

    monkeypatch.setattr(_kernels, "_lib", None)
    monkeypatch.setattr(_kernels, "library_path",
                        lambda checked=False: tmp_path / "libdr.so")
    monkeypatch.setattr(_kernels, "compile_library", compile_library)
    monkeypatch.setattr(_kernels.ctypes, "CDLL", StubCDLL)
    with tracing.recording():
        assert _kernels.library().path == str(tmp_path / "libdr.so")
        _kernels.library()  # loaded once
    assert built == [tmp_path / "libdr.so"]
    assert _tree(tracing.snapshot()) == [("dr.load", None),
                                         ("dr.build", "dr.load")]


def _window_rows(seed=5):
    """Three chunks of (4, L); chunk 1's row 2 is noise, past any cap of
    256 words, every other row well inside it."""
    x = np.vstack([_rows(4, seed=seed + i) for i in range(3)])
    x[6] = np.random.default_rng(seed).integers(-32768, 32768, L)
    return x


def test_batch_and_h5_spans_and_counters(monkeypatch):
    cfg = dt.RiceConfig(8, L)
    x = _window_rows()
    monkeypatch.setattr(codec, "_words_hint", lambda x2, cfg, length: 256)
    g = MemGroup()
    with tracing.recording():
        th5.write_dataset(g, "d", x, cfg, chunks=(4, L), batch_chunks=2,
                          device=CPU)
    snap = tracing.snapshot()
    assert snap["counters"]["rows_reencoded"] == 1
    assert snap["counters"]["rows_encoded"] == 12 + 1
    tree = _tree(snap)
    assert [n for n, p in tree if p is None] == ["dr.h5.write_window"] * 3
    tops = [s for s in snap["spans"] if s["parent"] is None]
    assert [s["chunks"] for s in tops] == [2, 1, 0]
    kids = {n for n, p in tree if p == "dr.compress_batch_dispatch"}
    assert kids == {"dr.pad_rows", "dr.words_hint", "dr.encode_segments"}
    kids = {n for n, p in tree if p == "dr.compress_batch_collect"}
    assert kids == {"dr.reencode", "dr.frame"}
    assert ("dr.encode_segments", "dr.reencode") in tree
    reencode = [s for s in snap["spans"] if s["name"] == "dr.reencode"]
    assert [s["rows"] for s in reencode] == [1]

    tracing.clear()
    with tracing.recording():
        got = th5.read_dataset(g["d"], batch_chunks=2, device=CPU)
    np.testing.assert_array_equal(got, x)
    snap = tracing.snapshot()
    tree = _tree(snap)
    assert [n for n, p in tree if p is None] == ["dr.h5.read_window"] * 3
    assert {n for n, p in tree if p == "dr.decompress_batch_dispatch"} == {
        "dr.walk_headers", "dr.gather", "dr.decode_bucket"}
    assert {n for n, p in tree if p == "dr.decompress_batch_collect"} == {
        "dr.copy_out"}
    assert snap["counters"]["rows_decoded"] == 12
    assert "rows_redecoded" not in snap["counters"]


def test_long_segments_split_spans(monkeypatch):
    """A long segment encodes whole: the batch's spans hold no split
    layout and no merge; its decode takes the split decode (forced on)."""
    n = 16384
    cfg = dt.RiceConfig(8, n)
    x = _rows(2, n, seed=7)
    monkeypatch.setenv("DELTARICE_TPU_SPLIT_DECODE", "1")
    monkeypatch.setattr(codec, "decode_split_parts", lambda *a: 4)
    with tracing.recording():
        blobs = dt.compress_batch([x], cfg, device=CPU)
        got = dt.decompress_batch(blobs, cfg, device=CPU)
    np.testing.assert_array_equal(got[0], x.ravel())
    snap = tracing.snapshot()
    tree = _tree(snap)
    assert {n for n, p in tree if p == "dr.compress_batch_dispatch"} == {
        "dr.pad_rows", "dr.words_hint", "dr.encode_segments"}
    assert {n for n, p in tree if p == "dr.compress_batch_collect"} == {
        "dr.frame"}
    assert not {n for n, _p in tree} & {"dr.split_layout", "dr.merge"}
    assert ("dr.split_decode", "dr.decode_bucket") in tree
    assert snap["counters"]["rows_encoded"] == 2
    assert snap["counters"]["rows_decoded"] == 2


def test_verify_retries_count_the_chunks_encoded_again(monkeypatch):
    cfg = dt.RiceConfig(8, 256)
    chunks = [_rows(4, 256, seed=s) for s in range(3)]
    monkeypatch.setattr(codec, "frame_stream",
                        hc.faulty_frames({1}, codec.frame_stream))
    with tracing.recording():
        got = dt.compress_batch(chunks, cfg, verify=True, device=CPU)
    for blob, x in zip(got, chunks):
        np.testing.assert_array_equal(
            dt.decompress(blob, cfg, device=CPU).reshape(x.shape), x)
    snap = tracing.snapshot()
    assert snap["counters"]["verify_retries"] == 1
    tree = _tree(snap)
    assert ("dr.verify", "dr.compress_batch_collect") in tree
    assert ("dr.decompress_batch_dispatch", "dr.verify") in tree


def test_redecoded_rows_are_counted_and_spanned():
    cfg = dt.RiceConfig(8, L)
    x = _rows()
    words, _ = dt.encode_segments(x, np.full(6, L, np.int32), cfg, 512,
                                  device=CPU)
    words_np = codec._host_words(words)
    garbage = np.zeros((6, L), np.int16)
    with tracing.recording():
        fixed = codec._redecode_bad_rows(garbage, np.array([0, 0, 1, 0, 0, 1]),
                                         words_np, L, cfg, CPU)
    np.testing.assert_array_equal(fixed[[2, 5]], x[[2, 5]])
    assert not fixed[[0, 1, 3, 4]].any()
    snap = tracing.snapshot()
    assert snap["counters"]["rows_redecoded"] == 2
    assert _tree(snap)[:2] == [("dr.redecode", None),
                               ("dr.decode_segments", "dr.redecode")]
    assert snap["spans"][0]["rows"] == 2
