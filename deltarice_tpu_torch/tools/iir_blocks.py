"""The generic inverse's blocked scan timed over block lengths: the
measurement behind ``ops/prefilter_model.py``'s choice of L
(:func:`..ops.prefilter_model.choose_block`). It has no JAX counterpart.

Run from the repository root::

    python -m deltarice_tpu_torch.tools.iir_blocks [--blocks 256,512,...]
        [--samples N] [--seed S] [--device cuda|cpu]

Three cases, each the shape the codec's decode hands the inverse: Nab
(2048, 7000) with ``optimize``'s (1, 0, -1), one NOPTREX h5 bucket (64,
500000) and one NOPTREX chunk (32, 500000) with (1, -1, 0, 1). The input is
seeded random int16: the kernels' work does not depend on the values.
``--samples`` cuts every row to its first N samples. The JSON gives, per
case, the milliseconds of one ``iir_decode`` call at each block length (on
the card: device time in a CUDA graph; on the CPU: the host clock's median
of windows of the plain model, ``prefilter_model.blocked_decode``), the
fastest length and the length ``choose_block`` takes for the shape.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops import prefilter_model
from ..ops.prefilter_cuda import iir_decode
from ..utils.profiling import NoCard, card, graph_ms, spread, windows

CASES = (("nab", (2048, 7000), (1, 0, -1)),
         ("noptrex bucket", (64, 500_000), (1, -1, 0, 1)),
         ("noptrex chunk", (32, 500_000), (1, -1, 0, 1)))
BLOCKS = (256, 512, 1024, 2048, 4096)


def run(blocks, samples: int | None, seed: int, device: str) -> dict:
    name = card(device)
    cuda = name is not None
    rng = np.random.default_rng(seed)
    cases = []
    for case, (rows, n), filt in CASES:
        n = n if samples is None else min(n, samples)
        d = torch.from_numpy(rng.integers(-2**15, 2**15, (rows, n),
                                          dtype=np.int16)).to(device)
        ms = {}
        for block in blocks:
            if cuda:
                ms[block] = graph_ms([lambda b=block: iir_decode(d, filt, b)])
            else:
                ms[block] = spread(windows(
                    prefilter_model.blocked_decode, d, filt, block, iters=1,
                    reps=3, device=device))["ms"]
        cases.append({"case": case, "shape": [rows, n], "filter": list(filt),
                      "ms": {str(b): v for b, v in ms.items()},
                      "fastest": min(ms, key=ms.get),
                      "chosen": prefilter_model.choose_block(rows, n)})
    return {"metric": "generic inverse ms a call by block length",
            "timer": "cuda graph" if cuda else "host clock",
            "seed": seed, "cases": cases,
            "platform": "gpu" if cuda else "cpu", "card": name}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m deltarice_tpu_torch.tools.iir_blocks")
    p.add_argument("--blocks", default=",".join(map(str, BLOCKS)),
                   help="block lengths, multiples of 8")
    p.add_argument("--samples", type=int, default=None,
                   help="cut every row to its first N samples")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; needs a card) or cpu")
    args = p.parse_args(argv)
    blocks = [int(b) for b in args.blocks.split(",")]
    try:
        rep = run(blocks, args.samples, args.seed, args.device)
    except NoCard as e:
        print(f"iir_blocks: {e}", file=sys.stderr)
        return 2
    print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
