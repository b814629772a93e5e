"""The check that decides ``correct`` fails what it must: the control (the
reference on 15-bit samples, in the program's place), and a run whose
timed path is broken underneath, once for each fault a one-card codec
cell can have: a call that hands back its last answer unchanged, half of
the batch left out, and one answer altered where it is produced. A cell on
one card has no exchange between chips to leave out. The same holds for a
configuration with a pre-filter other than the delta, which also fails a
program that runs the delta filter in its place. CPU, at a size a test run
holds; the harness's look for a card is skipped.

    python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import control  # noqa: E402
import run  # noqa: E402
from drbench import spec  # noqa: E402

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


#: the generic-filter configurations: Nab's with these filters
GENERIC = [("nab.vram_encode", (1, 0, -1)), ("nab.vram_decode", (1, 0, -1)),
           ("nab.vram_encode", (1, -2, 1)), ("nab.vram_decode", (1, -2, 1))]


def small(name: str, filt=None) -> spec.Cell:
    cell = spec.cell(name)
    length = 2000 if cell.traffic["op"] == "encode" else 600
    cell.config = dict(cell.config, chunk_rows=4, chunks_per_batch=1,
                       waveform_length=length)
    if filt is not None:
        cell.config["filter"] = list(filt)
    return cell


class Broken:
    """The program with one fault planted under its two entry points."""

    def __init__(self, program, fault: str):
        self.prog = program
        self.RiceConfig = program.RiceConfig
        self.fault = fault
        self.last = {}

    def _break(self, key, out: tuple) -> tuple:
        if self.fault == "unchanged":
            prev = self.last.get(key)
            self.last[key] = out
            return out if prev is None else prev
        out = tuple(t.clone() for t in out)
        if self.fault == "half":
            for t in out:
                t[t.shape[0] // 2:] = 0
        elif self.fault == "altered":
            out[0].view(-1)[0] += 1
        return out

    def encode_segments(self, x, nvalid, cfg, max_words, device="cuda"):
        out = self.prog.encode_segments(x, nvalid, cfg, max_words, device=device)
        return self._break(("encode", tuple(x.shape), max_words), out)

    def decode_segments(self, words, n_samples, cfg, device="cuda"):
        out = self.prog.decode_segments(words, n_samples, cfg, device=device)
        return self._break(("decode", tuple(words.shape)), (out,))[0]


class DeltaInstead:
    """The program, handed the delta filter whatever the configuration
    states."""

    def __init__(self, program):
        self.prog = program

    def RiceConfig(self, m, waveform_length, filt=None):
        return self.prog.RiceConfig(m, waveform_length)

    def encode_segments(self, *args, **kwargs):
        return self.prog.encode_segments(*args, **kwargs)

    def decode_segments(self, *args, **kwargs):
        return self.prog.decode_segments(*args, **kwargs)


@pytest.mark.parametrize(
    "name,filt", [pytest.param(c, None, id=c) for c in CELLS]
    + [pytest.param(c, f, id=f"{c}-{f}") for c, f in GENERIC])
def test_the_control_fails(name, filt):
    cell, seed = small(name, filt), 2**31 + 21
    res = run.run(cell, seed, 0.2, False, "cpu",
                  control.Control(cell, seed, "cpu"), 0.0)
    checks = res["checks"]
    wrong = checks.get("rows_wrong", checks.get("samples_wrong"))["value"]
    assert res["correct"] is False
    assert checks["calls_checked"]["value"] >= 1 and wrong > 0
    assert res["failed"] == checks["calls_checked"]["value"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    import deltarice_tpu_torch as program

    # a window long enough for calls on both resident batches even on a
    # loaded CPU: a call handed the last answer of the same batch is right
    res = run.run(small(name), 2**31 + 33, 1.0, False, "cpu",
                  Broken(program, fault), 0.0)
    assert res["correct"] is False
    assert res["failed"] >= 1


@pytest.mark.parametrize("name", ["nab.vram_encode", "nab.vram_decode"])
def test_the_delta_filter_in_place_of_the_stated_one_is_not_correct(name):
    import deltarice_tpu_torch as program

    res = run.run(small(name, (1, 0, -1)), 2**31 + 35, 0.2, False, "cpu",
                  DeltaInstead(program), 0.0)
    assert res["correct"] is False
    assert res["failed"] == res["checks"]["calls_checked"]["value"] >= 1


def test_the_control_is_lossy_by_one_bit():
    x = torch.tensor([[-3, -2, 0, 1, 32767]], dtype=torch.int16)
    assert control.lossy(x).tolist() == [[-4, -2, 0, 0, 32766]]
