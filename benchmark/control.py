"""The control of the check that decides ``correct``: the plain reference
put in the program's place, computed one step below what the
configuration states (lossless int16): its samples with the lowest bit
dropped, as a 15-bit codec would keep them, coded with the configuration's
pre-filter. It runs a cell's own traffic, at the cell's size, through
``run.run`` (the same set-up, window and comparison as a benchmark run),
and prints each run's readings and its ``correct``, which has to come out
false.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--seconds 3]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import torch  # noqa: E402

from drbench import engine, reference, spec  # noqa: E402


def lossy(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its lowest bit dropped."""
    return x & -2


@dataclasses.dataclass(frozen=True)
class RiceConfig:
    m: int
    waveform_length: int
    filt: tuple = reference.DELTA

    def max_words(self, n: int) -> int:
        return reference.max_words(n, self.m)


class Control:
    """The program's two entry points, answered by the reference on the
    lossy samples. A decode is answered from the samples its plane was made
    from: on a plane's first call, the control makes the cell's resident
    inputs from the seed itself, finds the plane among them, and keeps the
    samples by the plane's address."""

    RiceConfig = RiceConfig

    def __init__(self, cell: spec.Cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.samples = {}
        self.own = None

    def encode_segments(self, x, nvalid, cfg, max_words, device=None):
        words, nwords = reference.encode_blocks(lossy(x), nvalid, cfg.m,
                                                max_words, cfg.filt)
        return words, nwords.to(torch.int32)

    def decode_segments(self, words, n_samples, cfg, device=None):
        key = words.data_ptr()
        if key not in self.samples:
            if self.own is None:
                self.own = engine.Workload(self, self.cell.config,
                                           self.cell.traffic, self.seed,
                                           self.device)
            b = next(b for b, p in enumerate(self.own.planes)
                     if p.shape == words.shape and torch.equal(p, words))
            self.samples[key] = self.own.x[b]
        return lossy(self.samples[key])[:, :n_samples]


def main(argv=None) -> int:
    import run

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.run(cell, seed, args.seconds, False, args.device,
                      Control(cell, seed, args.device), time.perf_counter())
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "failed": res["failed"], "checks": res["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
