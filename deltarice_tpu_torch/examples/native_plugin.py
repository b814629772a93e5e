"""Use the native C filter through HDF5's own filter pipeline, then read
the same file through the port.

Run: ``python -m deltarice_tpu_torch.examples.native_plugin [--device
cpu]``. Registers the plugin (built from the repository's C sources) into
h5py's HDF5, writes ``native.h5`` in the working directory with plain h5py
(the C codec runs inside libhdf5), reads it back with plain h5py and with
``deltarice_tpu_torch.h5.read_dataset`` on ``--device``.
"""

from __future__ import annotations

import argparse

import h5py
import numpy as np

from deltarice_tpu_torch import H5FILTER, h5


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m deltarice_tpu_torch.examples.native_plugin")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if not h5.register_h5_filter():
        raise SystemExit("native filter build or registration failed")
    data = np.arange(-32768, 32768, dtype=np.int16).reshape(16, 4096)
    with h5py.File("native.h5", "w") as f:
        f.create_dataset("d", data=data, chunks=(4, 4096),
                         compression=H5FILTER, compression_opts=(8, 4096),
                         allow_unknown_filter=True)
    with h5py.File("native.h5", "r") as f:
        plain = f["d"][()]
        port = h5.read_dataset(f["d"], device=args.device)
    if not (np.array_equal(plain, data) and np.array_equal(port, data)):
        raise SystemExit("read back differs from the data written")
    print(f"ok: full int16 range through the C filter pipeline, read back "
          f"by h5py and by the port on {args.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
