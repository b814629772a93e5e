"""Finds a cell's parts by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic file under ``traffic/`` and a reader under
``metrics/`` for each of its metrics. A cell, a traffic mix or a metric is
added by adding files and entries; nothing here names one.

A configuration file states the deployment's codec settings as the
reference filter's ``cd_values`` order them, ``(M, L, n, *filter)``:
``rice_m``, ``waveform_length`` and ``filter``. The filter may be any
lossless causal integer filter, int32 taps with ``|filter[0]| == 1``; the
traffic, the reference, the word cap, the check and the control all
follow it."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]  # the benchmark's folder
CHECKOUT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    chips: int


def load_benchmark(root: Path = CHECKOUT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None, root: Path = CHECKOUT) -> Cell:
    bench = load_benchmark(root) if bench is None else bench
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"there are {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=name, config=config, traffic=traffic, chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def reader(metric: str):
    """The ``read(ctx, part)`` of a per-layer metric: ``metrics/<name>.py``,
    or else ``metrics/<quantity>.py`` for ``<quantity>.<part>``, which then
    gets ``part``."""
    quantity, _, part = metric.partition(".")
    for stem, arg in ((metric, None), (quantity, part or None)):
        path = HERE / "metrics" / f"{stem}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(
                f"drbench_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return lambda ctx, _read=mod.read, _arg=arg: _read(ctx, _arg)
    raise FileNotFoundError(f"no reader for metric {metric!r} under "
                            f"{HERE / 'metrics'}")
