"""Write and read one HDF5 dataset through the port's direct-chunk path.

Run: ``python -m deltarice_tpu_torch.examples.basic_roundtrip [--device
cpu]``. Writes ``testFile.h5`` in the working directory (needs h5py): 100
random-walk waveforms of 7000 samples in chunks of (20, 7000), M=8, read
back exactly.
"""

from __future__ import annotations

import argparse
import os

import h5py
import numpy as np

import deltarice_tpu_torch as dt
from deltarice_tpu_torch import h5


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m deltarice_tpu_torch.examples.basic_roundtrip")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    rng = np.random.default_rng(0)
    data = np.round(np.cumsum(rng.normal(0, 10, (100, 7000)), axis=-1)
                    ).astype(np.int16)
    cfg = dt.RiceConfig(m=8, waveform_length=7000)
    with h5py.File("testFile.h5", "w") as f:
        h5.write_dataset(f, "testData", data, cfg, chunks=(20, 7000),
                         device=args.device)
    with h5py.File("testFile.h5", "r") as f:
        back = h5.read_dataset(f["testData"], device=args.device)
    if not np.array_equal(back, data):
        raise SystemExit("read back differs from the data written")
    size = os.path.getsize("testFile.h5")
    print(f"ok: {data.nbytes} raw -> {size} in file "
          f"({size / data.nbytes:.1%}) on {args.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
