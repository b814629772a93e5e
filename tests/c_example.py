"""The pure-C HDF5 example (``examples/c/dr_roundtrip.c``) built against the
port's native library, shared by the CPU test (``test_torch_c_example.py``)
and the card test (``test_torch_cuda.py``).

The example registers filter 32025 into a system libhdf5 (not h5py's
bundled copy), writes a chunked (512, 1024) int16 dataset ``waveforms``
through the standard filter pipeline and checks its read-back. It needs what
``tests/test_c_example.py`` needs: a C compiler and a system libhdf5.
"""

from __future__ import annotations

import glob
import shutil
import subprocess
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
EXAMPLE = REPO / "examples" / "c" / "dr_roundtrip.c"
ROWS, COLS = 512, 1024


def system_hdf5() -> str | None:
    """The system libhdf5 runtime, found as ``tests/test_c_example.py``
    finds it."""
    for pat in (
        "/usr/lib/*/libhdf5_serial.so*",
        "/usr/lib/*/libhdf5.so*",
        "/usr/lib64/libhdf5.so*",
    ):
        hits = sorted(glob.glob(pat))
        if hits:
            return hits[0]
    return None


def toolchain() -> tuple[str, str] | None:
    """(C compiler, system libhdf5), or None where either is missing."""
    cc = shutil.which("cc") or shutil.which("gcc")
    hdf5 = system_hdf5()
    return None if cc is None or hdf5 is None else (cc, hdf5)


def build_example(cc: str, hdf5: str, out: Path) -> Path:
    """Compile the example against the port's ``native.library_path()``
    (built first where needed) and the system libhdf5."""
    from deltarice_tpu_torch import native

    lib = native.ensure_built()
    assert lib == native.library_path()
    subprocess.run([cc, str(EXAMPLE), "-o", str(out), str(lib), hdf5],
                   check=True, capture_output=True, text=True)
    return out


def write_file(binary: Path, h5file: Path) -> str:
    """Run the example, writing ``h5file``; returns its standard output."""
    res = subprocess.run([str(binary), str(h5file)], capture_output=True,
                         text=True, env={"LD_LIBRARY_PATH": str(binary.parent)})
    assert res.returncode == 0, res.stderr
    return res.stdout


def example_data() -> np.ndarray:
    """The example's samples: each row a wrapping int16 walk from r - 256 by
    steps ((r * 131 + c * 7919) % 13) - 6."""
    r = np.arange(ROWS, dtype=np.int64)[:, None]
    c = np.arange(COLS, dtype=np.int64)[None, :]
    steps = (r * 131 + c * 7919) % 13 - 6
    return ((r - ROWS // 2) + np.cumsum(steps, axis=1)).astype(np.int16)
