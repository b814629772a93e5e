"""CPU tests of the per-layer metrics read from the program's tracer
(``deltarice_tpu_torch.tracing``): on a traced run through ``run.run``
each reader returns its value, the device events read None on the CPU, and
a run whose traffic made no traced call of the cell's rows reads None,
not 0. A program without the tracer reads None too.

    python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import run  # noqa: E402
from drbench import spec  # noqa: E402

BENCHMARK = spec.load_benchmark()
READERS = ["entry_self_ms", "wrapper_host_ms", "kernel_device_ms",
           "fill_device_ms"]
HOST = {"entry_self_ms", "wrapper_host_ms"}
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


def small(name: str) -> spec.Cell:
    cell = spec.cell(name)
    length = 2000 if cell.traffic["op"] == "encode" else 600
    cell.config = dict(cell.config, chunk_rows=4, chunks_per_batch=1,
                       waveform_length=length)
    return cell


def _tracer_metrics(cell: spec.Cell) -> list[str]:
    return [m["name"] for m in cell.per_layer
            if m["name"].split(".")[0] in READERS]


@pytest.fixture
def clean_tracer():
    from deltarice_tpu_torch import tracing

    tracing.clear()
    yield tracing
    tracing.clear()


def test_each_cell_names_the_tracers_metrics_of_its_op():
    want = {"encode": {"entry_self_ms.encode", "wrapper_host_ms.encode",
                       "kernel_device_ms.encode", "fill_device_ms.encode"},
            "decode": {"entry_self_ms.decode", "wrapper_host_ms.decode",
                       "kernel_device_ms.decode"}}
    for name in CELLS:
        cell = spec.cell(name)
        assert set(_tracer_metrics(cell)) == want[cell.traffic["op"]]
    layers = {m["name"]: m["layer"] for m in BENCHMARK["per_layer"]}
    assert layers["entry_self_ms.encode"] == "Codec entry"
    assert layers["kernel_device_ms.decode"] == "Kernels"


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_cpu_run_reads_the_host_spans(name, clean_tracer):
    import deltarice_tpu_torch as program

    cell = small(name)
    res = run.run(cell, 2**31 + 21, 0.2, True, "cpu", program, 0.0)
    assert res["correct"]
    for metric in _tracer_metrics(cell):
        if metric.split(".")[0] in HOST:
            value = res["metrics"][metric]["value"]
            assert value > 0
        else:  # no CUDA event on the CPU
            assert metric not in res["metrics"]
    entry = res["metrics"][f"entry_self_ms.{cell.traffic['op']}"]["value"]
    wrapper = res["metrics"][f"wrapper_host_ms.{cell.traffic['op']}"]["value"]
    assert entry < wrapper  # the entry's own time leaves its wrapper out


def _ctx(op: str, rows: int) -> dict:
    return {"op": op, "rows": rows, "trace": None, "enqueue_s": [],
            "length": 100, "traced_calls": 0, "traced_stream_words": 0}


@pytest.mark.parametrize("name", ["entry_self_ms.encode",
                                  "wrapper_host_ms.decode",
                                  "kernel_device_ms.encode",
                                  "fill_device_ms.encode"])
def test_no_traced_call_of_the_cells_rows_reads_none(name, clean_tracer):
    import numpy as np

    import deltarice_tpu_torch as dt

    read = spec.reader(name)
    op = name.split(".")[1]
    assert read(_ctx(op, 4)) is None  # nothing traced at all
    cfg = dt.RiceConfig(8, 100)
    x = np.zeros((3, 100), np.int16)
    with clean_tracer.recording():
        words, _ = dt.encode_segments(x, np.full(3, 100, np.int32), cfg, 256,
                                      device="cpu")
        dt.decode_segments(words, 100, cfg, device="cpu")
    assert read(_ctx(op, 4)) is None  # traced calls of 3 rows only
    assert read(_ctx("decode" if op == "encode" else "encode", 3)) is None
    if name.split(".")[0] in HOST:
        assert read(_ctx(op, 3)) > 0


@pytest.mark.parametrize("name", ["entry_self_ms.decode",
                                  "wrapper_host_ms.encode",
                                  "kernel_device_ms.decode",
                                  "fill_device_ms.encode"])
def test_a_program_without_the_tracer_reads_none(name, monkeypatch,
                                                 clean_tracer):
    import numpy as np

    import deltarice_tpu_torch as dt

    cfg = dt.RiceConfig(8, 100)
    with clean_tracer.recording():
        words, _ = dt.encode_segments(np.zeros((4, 100), np.int16),
                                      np.full(4, 100, np.int32), cfg, 256,
                                      device="cpu")
        dt.decode_segments(words, 100, cfg, device="cpu")
    read = spec.reader(name)
    ctx = _ctx(name.split(".")[1], 4)
    assert (read(ctx) is not None) == (name.split(".")[0] in HOST)
    monkeypatch.delattr(dt, "tracing")
    monkeypatch.setitem(sys.modules, "deltarice_tpu_torch.tracing", None)
    assert read(ctx) is None
