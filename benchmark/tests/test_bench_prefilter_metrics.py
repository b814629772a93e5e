"""CPU tests of the generic pre-filter's per-layer metrics and of the
``nab_opt`` configuration: ``prefilter_device_ms`` and
``prefilter_roofline`` read None off the tracer, on a delta cell and where
no call recorded the program's event pair (every CPU run), and the
roofline's bytes on a hand-made case; ``nab_opt`` and its two cells pass
the harness's own loops over ``BENCHMARK.json`` (the contract's shape, the
per-cell file lookup, the word cap).

    python -m pytest benchmark/tests -q
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT), str(Path(__file__).parent)]

import run  # noqa: E402
from drbench import roofline, spec  # noqa: E402
from test_bench_harness import (_cell_found_by_its_files,  # noqa: E402
                                _contract_shape, _words_hint_of_each_config)

BENCHMARK = spec.load_benchmark()
NEW = ["prefilter_device_ms.encode", "prefilter_device_ms.decode",
       "prefilter_roofline.encode", "prefilter_roofline.decode"]
CELLS = ["nab_opt.vram_encode", "nab_opt.vram_decode"]


@pytest.fixture
def clean_tracer():
    from deltarice_tpu_torch import tracing

    tracing.clear()
    yield tracing
    tracing.clear()


def _ctx(op: str, rows: int, length: int = 100) -> dict:
    return {"op": op, "rows": rows, "trace": None, "enqueue_s": [],
            "length": length, "traced_calls": 0, "traced_stream_words": 0}


def _traced_calls(tracing, filt, rows=4, length=100):
    import deltarice_tpu_torch as dt

    cfg = dt.RiceConfig(8, length, filt=filt)
    x = np.cumsum(np.random.default_rng(1).integers(-9, 10, (rows, length)),
                  axis=1).astype(np.int16)
    with tracing.recording():
        words, _ = dt.encode_segments(x, np.full(rows, length, np.int32), cfg,
                                      cfg.max_words(length), device="cpu")
        dt.decode_segments(words, length, cfg, device="cpu")


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("filt", [(1, 0, -1), (1, -1)], ids=["generic", "delta"])
def test_the_readers_read_none_without_the_event(name, filt, clean_tracer):
    read = spec.reader(name)
    op = name.split(".")[1]
    assert read(_ctx(op, 4)) is None  # nothing traced at all
    _traced_calls(clean_tracer, filt)
    spans = {s["name"] for s in clean_tracer.snapshot()["spans"]}
    assert ("dr.prefilter" in spans) == (filt != (1, -1))
    assert read(_ctx(op, 4)) is None  # no CUDA event on the CPU
    assert read(_ctx("decode" if op == "encode" else "encode", 4)) is None


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_tracer_reads_none(name, monkeypatch,
                                                 clean_tracer):
    import deltarice_tpu_torch as dt

    monkeypatch.delattr(dt, "tracing")
    monkeypatch.setitem(sys.modules, "deltarice_tpu_torch.tracing", None)
    assert spec.reader(name)(_ctx(name.split(".")[1], 4)) is None


@pytest.mark.parametrize("op,event", [("encode", "prefilter"),
                                      ("decode", "prefilter_inverse")])
def test_the_readers_on_a_hand_made_event(op, event, monkeypatch,
                                          clean_tracer):
    # 3 rows of 10 samples: 60 bytes read and 60 written in 0.25 ms
    seen = []

    def event_ms(snap, top, rows, name):
        seen.append((top, rows, name))
        return 0.25 if (top, rows, name) == (
            clean_tracer.ENTRY[op], 3, event) else None

    monkeypatch.setattr(clean_tracer, "event_ms", event_ms)
    ctx = _ctx(op, 3, length=10)
    assert spec.reader(f"prefilter_device_ms.{op}")(ctx) == 0.25
    share = spec.reader(f"prefilter_roofline.{op}")(ctx)
    assert share == pytest.approx(
        100.0 * 120 / roofline.HBM_BYTES_PER_S / 0.25e-3)
    assert spec.reader(f"prefilter_roofline.{op}")(_ctx(op, 4, 10)) is None
    assert seen[0] == (clean_tracer.ENTRY[op], 3, event)


def test_prefilter_bytes_are_the_samples_read_and_written():
    path = BENCH / "metrics" / "prefilter_roofline.py"
    mod_spec = importlib.util.spec_from_file_location("prefilter_roofline", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    assert mod.prefilter_bytes(3, 10) == 2 * 30 + 2 * 30
    assert mod.prefilter_bytes(20000, 7000) == 560_000_000
    # the Nab batch at the bandwidth bound: 0.167 ms
    assert mod.prefilter_bytes(20000, 7000) / roofline.HBM_BYTES_PER_S \
        == pytest.approx(0.167e-3, rel=0.01)


def test_nab_opt_passes_the_harness_loops():
    _contract_shape(BENCHMARK, ROOT)
    for name in CELLS:
        _cell_found_by_its_files(name, BENCHMARK, ROOT)
    _words_hint_of_each_config(BENCHMARK, ROOT)


def test_nab_opt_is_nab_with_the_optimizers_filter():
    nab = json.loads((BENCH / "configs" / "nab.json").read_text())
    opt = json.loads((BENCH / "configs" / "nab_opt.json").read_text())
    assert set(opt) == set(nab)
    assert set(opt["assumed"]) >= set(nab["assumed"]) | {"filter"}
    same = ("chunk_rows", "chunks_per_batch", "waveform_length", "rice_m",
            "noise_sigma", "published_ratio", "guarantees", "storage",
            "reduced")
    assert {k: opt[k] for k in same} == {k: nab[k] for k in same}
    assert opt["filter"] == [1, 0, -1]
    assert opt["plane_words"] % 256 == 0
    conf = {c["name"]: c for c in BENCHMARK["configs"]}["nab_opt"]
    assert conf["reduced"] == list(opt["reduced"]) == ["storage"]
    assert conf["source"] == opt["source"]


def test_each_new_cell_reports_what_its_nab_twin_does_and_its_layer():
    for name in CELLS:
        twin = name.replace("nab_opt.", "nab.")
        cell, nab = spec.cell(name), spec.cell(twin)
        assert ([m["name"] for m in cell.end_to_end]
                == [m["name"] for m in nab.end_to_end])
        op = cell.traffic["op"]
        assert ([m["name"] for m in cell.per_layer]
                == [m["name"] for m in nab.per_layer]
                + [f"prefilter_device_ms.{op}", f"prefilter_roofline.{op}"])
    for m in BENCHMARK["per_layer"]:
        if m["name"] in NEW:
            op = m["name"].split(".")[1]
            assert m["workloads"] == [f"nab_opt.vram_{op}"]
            assert (m["layer"], m["moves"]) == ("Pre-filter", f"{op}_GBps")


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_cpu_run_of_nab_opt_leaves_the_device_metrics_out(
        name, clean_tracer):
    import deltarice_tpu_torch as program

    cell = spec.cell(name)
    length = 2000 if cell.traffic["op"] == "encode" else 600
    cell.config = dict(cell.config, chunk_rows=4, chunks_per_batch=1,
                       waveform_length=length)
    res = run.run(cell, 2**31 + 31, 0.2, True, "cpu", program, 0.0)
    assert res["correct"] and res["checks"]["calls_checked"]["value"] >= 1
    assert not set(res["metrics"]) & set(NEW)
    counters = clean_tracer.snapshot()["counters"]
    key = ("rows_prefiltered" if cell.traffic["op"] == "encode"
           else "rows_prefilter_inverted")
    assert counters[key] > 0
