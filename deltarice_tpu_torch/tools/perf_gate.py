"""Perf-regression gate of the port: a fresh ``python -m
deltarice_tpu_torch.bench`` line against the best committed baseline of the
same card. The port's counterpart of the JAX package's
``tools/perf_gate.py``, with the same parsing, verdict line, arithmetic and
exit codes.

Run from the repository root::

    python -m deltarice_tpu_torch.tools.perf_gate [bench.log]
        [--threshold 0.10] [--baselines DIR]

The fresh input is a file holding the bench's output (the gate takes the
last JSON line with ``"metric"``); without one the gate runs ``python -m
deltarice_tpu_torch.bench`` on the card. It gates the line's ``value``, the
harmonic mean of B1 encode and B2 decode GB/s on device-resident data, and
none of ``detail``'s whole-batch numbers, which move far more between runs
than the threshold.

The yardstick is the card's own: the baselines are bench lines committed
as ``baselines/BENCH_r*.json`` (the bench's last line and a ``commit``
key), and only those whose ``card`` (the card's name and power limit, as
``nvidia-smi --query-gpu=name,power.limit`` gives them) equals the fresh
line's are read, the best of them, not the latest. A baseline of another
card or another power limit never gates this one, and the JAX package's
``BENCH_r*.json`` (TPU runs) are never read.

Exit codes: 0 within the threshold or with no baseline for this card; 1
when the fresh value drops more than the threshold below the baseline; 2
when there is no measurement on a card: a fresh line without a card (a
``--device cpu`` bench), or no file on a machine without a card. The gate
never measures on the CPU.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

PACKAGE_PARENT = Path(__file__).resolve().parents[2]
BASELINES = Path(__file__).resolve().parent / "baselines"
BENCH_TIMEOUT_S = 1200


class NoMeasurement(RuntimeError):
    """The bench found no card, so there is nothing to gate."""


def _artifact_value(path) -> float:
    """``value`` of a bare bench line, or of the bench line inside a run
    record's ``"tail"`` text, as the root ``BENCH_r*.json`` hold it (0.0
    where it has none)."""
    with open(path) as f:
        art = json.load(f)
    if "value" in art:  # bare bench line
        return float(art["value"])
    m = re.search(r'\\"value\\": ([0-9.]+)|"value": ([0-9.]+)',
                  art.get("tail", ""))
    return float(m.group(1) or m.group(2)) if m else 0.0


def last_committed(card: str, baselines=BASELINES) -> tuple[str, float]:
    """Best committed baseline of ``card``: the BEST, not the latest, so a
    regression that already shipped once cannot lower the bar. ("none",
    0.0) where no baseline names this card; a baseline that names no card
    (a CPU run, a TPU artifact) gates nothing."""
    vals = []
    for p in sorted(Path(baselines).glob("BENCH_r*.json")):
        named = json.loads(p.read_text()).get("card")
        if named is not None and named == card:
            vals.append((p.name, _artifact_value(p)))
    if not vals:
        return "none", 0.0
    return max(vals, key=lambda nv: nv[1])


def _bench_output() -> str:
    """Standard output of ``python -m deltarice_tpu_torch.bench`` on the
    card; raises :class:`NoMeasurement` on its no-card exit (2)."""
    res = subprocess.run(
        [sys.executable, "-m", "deltarice_tpu_torch.bench"],
        capture_output=True, text=True, timeout=BENCH_TIMEOUT_S,
        cwd=PACKAGE_PARENT)
    if res.returncode == 2:
        raise NoMeasurement(res.stderr.strip())
    return res.stdout


def fresh_line(source) -> dict:
    """The last JSON line with ``"metric"`` of ``source`` (a file), or of a
    bench run when ``source`` is None."""
    if source:
        with open(source) as f:
            text = f.read()
    else:
        text = _bench_output()
    for line in reversed(text.strip().splitlines()):
        m = re.search(r"\{.*\"metric\".*\}", line)
        if m:
            return json.loads(m.group(0))
    raise SystemExit(f"no bench JSON line found in "
                     f"{source or 'python -m deltarice_tpu_torch.bench'}")


def fresh_value(source) -> float:
    return float(fresh_line(source)["value"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deltarice_tpu_torch.tools.perf_gate")
    ap.add_argument("fresh", nargs="?", default=None,
                    help="bench output file (runs the bench on the card if "
                         "omitted)")
    ap.add_argument("--threshold", type=float, default=0.10)
    ap.add_argument("--baselines", default=str(BASELINES),
                    help="directory of the committed BENCH_r*.json")
    args = ap.parse_args(argv)
    try:
        line = fresh_line(args.fresh)
    except NoMeasurement as e:
        print(f"perf gate: no card, so no measurement to gate ({e})",
              file=sys.stderr)
        return 2
    fresh = float(line["value"])
    card = line.get("card")
    if card is None:
        print(f"perf gate: the fresh line names no card (a --device cpu "
              f"bench); only a run on a card is gated; fresh = {fresh:.3f}",
              file=sys.stderr)
        return 2
    name, prev = last_committed(card, args.baselines)
    if prev <= 0:
        print(f"perf gate: no committed baseline for {card}; "
              f"fresh = {fresh:.3f}")
        return 0
    drop = 1.0 - fresh / prev
    status = "FAIL" if drop > args.threshold else "ok"
    print(f"perf gate [{status}]: fresh {fresh:.3f} vs {name} {prev:.3f} "
          f"({-drop * 100:+.1f}%; threshold -{args.threshold * 100:.0f}%)")
    return 1 if drop > args.threshold else 0


if __name__ == "__main__":
    sys.exit(main())
