"""The port's perf gate (``deltarice_tpu_torch.tools.perf_gate``) against the
JAX package's ``tools/perf_gate.py``, on the CPU.

The JAX tool is imported from the repository by path. Both tools get the
same inputs: the committed ``BENCH_r*.json``, bench logs and a baseline of
the same value (the JAX tool's under a monkeypatched ``ROOT``, the port's in
a baselines directory of its own). Values, exit codes and the verdict line
must be equal; tolerance 0 (the same arithmetic on the same floats). Then
what the port adds: baselines gate only a fresh line of their own card and
power limit, and nothing measured off a card is gated.
"""

from __future__ import annotations

import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from deltarice_tpu_torch import bench
from deltarice_tpu_torch.tools import perf_gate

REPO = Path(__file__).resolve().parent.parent
JAX_ARTIFACTS = sorted(REPO.glob("BENCH_r*.json"))
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
METRIC = "int16 delta-rice encode+decode harmonic-mean throughput per card"


@pytest.fixture(scope="module")
def jgate():
    """``tools/perf_gate.py`` of the JAX package, imported by path."""
    spec = importlib.util.spec_from_file_location(
        "jax_tool_perf_gate", REPO / "tools" / "perf_gate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cpu_bench_log(tmp_path_factory):
    """The output of a small ``--device cpu`` bench: a line whose ``card``
    is null."""
    path = tmp_path_factory.mktemp("bench") / "cpu.log"
    report = bench.run(nseg=4, iters=1, reps=1, device="cpu")
    path.write_text("noise before\n" + json.dumps(report) + "\n")
    return path, report


def _line(value: float, card=CARD, **extra) -> dict:
    return {"metric": METRIC, "value": value, "unit": "GB/s", "card": card,
            **extra}


def _log(path: Path, value: float, card=CARD) -> Path:
    path.write_text("building kernels ...\n"
                    "[warm-up] 3 calls\n"
                    f"{json.dumps(_line(value, card))}\n"
                    "done\n")
    return path


def _baselines(directory: Path, *lines: dict) -> Path:
    directory.mkdir(parents=True, exist_ok=True)
    for i, line in enumerate(lines, 1):
        (directory / f"BENCH_r{i:02d}.json").write_text(json.dumps(line))
    return directory


@pytest.mark.parametrize(
    "name", [p.name for p in JAX_ARTIFACTS] + ["bare line"])
def test_artifact_value_is_the_jax_tools(name, jgate, tmp_path):
    if name == "bare line":
        path = tmp_path / "bare.json"
        path.write_text(json.dumps(_line(12.345)))
        want = 12.345
    else:
        path = REPO / name
        want = {"BENCH_r05.json": 29.475}.get(name)
    got = perf_gate._artifact_value(path)
    assert got == jgate._artifact_value(str(path))
    if want is not None:
        assert got == want


def test_the_jax_artifacts_are_never_a_baseline(jgate):
    """The JAX tool's best is BENCH_r05.json (a TPU run); the port reads the
    same files as naming no card, so none of them gates any card."""
    assert len(JAX_ARTIFACTS) == 5
    assert jgate.last_committed() == ("BENCH_r05.json", 29.475)
    for card in (CARD, None):
        assert perf_gate.last_committed(card, REPO) == ("none", 0.0)


def test_fresh_value_is_the_jax_tools(jgate, tmp_path):
    log = _log(tmp_path / "bench.log", 97.74456263323546)
    assert (perf_gate.fresh_value(str(log)) == jgate.fresh_value(str(log))
            == 97.74456263323546)
    assert perf_gate.fresh_line(str(log))["card"] == CARD


def test_fresh_value_raises_as_the_jax_tools_without_a_line(jgate, tmp_path):
    log = tmp_path / "bench.log"
    log.write_text("building kernels ...\n{\"value\": 3.0}\nTraceback\n")
    for fn in (perf_gate.fresh_value, jgate.fresh_value):
        with pytest.raises(SystemExit, match="no bench JSON line"):
            fn(str(log))


@pytest.mark.parametrize("drop,rc", [(-0.05, 0), (0.099, 0), (0.101, 1),
                                     (0.5, 1)])
def test_verdict_is_the_jax_tools(drop, rc, jgate, tmp_path, monkeypatch,
                                  capsys):
    prev = 98.10335412097183
    log = _log(tmp_path / "bench.log", prev * (1.0 - drop))
    jroot = _baselines(tmp_path / "jax", {"value": prev})
    monkeypatch.setattr(jgate, "ROOT", str(jroot))
    monkeypatch.setattr(sys, "argv", ["perf_gate.py", str(log)])
    assert jgate.main() == rc
    jout = capsys.readouterr().out
    port = _baselines(tmp_path / "port", _line(prev, commit="0" * 40))
    assert perf_gate.main([str(log), "--baselines", str(port)]) == rc
    out = capsys.readouterr().out
    assert out == jout
    status = "FAIL" if rc else "ok"
    assert re.fullmatch(
        rf"perf gate \[{status}\]: fresh [0-9.]+ vs BENCH_r01.json "
        rf"98.103 \([+-][0-9.]+%; threshold -10%\)\n", out)
    assert f"({-drop * 100:+.1f}%;" in out


def test_best_not_latest_of_the_same_card(tmp_path, capsys):
    port = _baselines(tmp_path / "port", _line(50.0), _line(40.0),
                      _line(60.0, card="NVIDIA H100 80GB HBM3, 500.00 W"),
                      _line(70.0, card="NVIDIA A100-SXM4-80GB, 400.00 W"))
    assert perf_gate.last_committed(CARD, port) == ("BENCH_r01.json", 50.0)
    assert perf_gate.main([str(_log(tmp_path / "a.log", 46.0)),
                           "--baselines", str(port)]) == 0
    assert "[ok]" in capsys.readouterr().out
    # above the latest baseline (40), below the best by 12 %
    assert perf_gate.main([str(_log(tmp_path / "b.log", 44.0)),
                           "--baselines", str(port)]) == 1
    assert "vs BENCH_r01.json 50.000 (-12.0%" in capsys.readouterr().out


def test_another_cards_baseline_is_ignored(tmp_path, capsys):
    port = _baselines(tmp_path / "port",
                      _line(500.0, card="NVIDIA H100 80GB HBM3, 500.00 W"),
                      _line(500.0, card="NVIDIA H200, 700.00 W"))
    log = _log(tmp_path / "bench.log", 10.0)
    assert perf_gate.main([str(log), "--baselines", str(port)]) == 0
    assert capsys.readouterr().out == (
        f"perf gate: no committed baseline for {CARD}; fresh = 10.000\n")


def test_a_cpu_bench_line_is_refused(cpu_bench_log, tmp_path, capsys):
    log, report = cpu_bench_log
    assert report["card"] is None and report["detail"]["platform"] == "cpu"
    port = _baselines(tmp_path / "port", _line(report["value"], card=None))
    assert perf_gate.main([str(log), "--baselines", str(port)]) == 2
    cap = capsys.readouterr()
    assert cap.out == ""
    assert "names no card" in cap.err


def test_no_file_and_no_card_exits_2(capsys):
    """Without a file the gate runs the bench on the card; on a machine
    without one the bench exits 2 and so does the gate, measuring
    nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the gate would measure on it")
    assert perf_gate.main([]) == 2
    cap = capsys.readouterr()
    assert cap.out == ""
    assert "no card" in cap.err and "needs a CUDA card" in cap.err


def test_import_loads_neither_jax_nor_the_jax_package():
    code = ("import json, sys\n"
            "import deltarice_tpu_torch.tools.perf_gate\n"
            "print(json.dumps(sorted(m for m in sys.modules\n"
            "    if m.split('.')[0] in ('jax', 'jaxlib', 'deltarice_tpu'))))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout) == []


def test_committed_baseline(cpu_bench_log, capsys):
    path = perf_gate.BASELINES / "BENCH_r01.json"
    text = path.read_text()
    assert text.count("\n") == 1  # one line, as the bench printed it
    line = json.loads(text)
    assert re.fullmatch(r"NVIDIA .+, \d+\.\d+ W", line["card"])
    assert line["detail"]["round_trip"] == "exact"
    assert line["detail"]["platform"] == "gpu"
    assert re.fullmatch(r"[0-9a-f]{40}", line["commit"])
    assert line["metric"] == METRIC and line["unit"] == "GB/s"
    assert perf_gate._artifact_value(path) == line["value"] > 0
    # the bench's own keys, and only the commit beside them
    _, report = cpu_bench_log
    assert set(line) == set(report) | {"commit"}
    assert set(line["detail"]) == set(report["detail"])
    # its own line gates its card at a drop of 0 (printed "-0.0%", as the
    # JAX tool's arithmetic prints it)
    assert perf_gate.last_committed(line["card"]) == ("BENCH_r01.json",
                                                      line["value"])
    assert perf_gate.main([str(path)]) == 0
    assert capsys.readouterr().out == (
        f"perf gate [ok]: fresh {line['value']:.3f} vs BENCH_r01.json "
        f"{line['value']:.3f} (-0.0%; threshold -10%)\n")
