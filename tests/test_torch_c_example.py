"""The pure-C HDF5 example against the port: the counterpart of
``tests/test_c_example.py``.

``examples/c/dr_roundtrip.c`` is compiled against the port's native library
(``deltarice_tpu_torch.native.library_path()``) and a system libhdf5,
writes a chunked dataset through the standard filter pipeline and checks its
read-back; the port then reads that file with ``device="cpu"``. It must
equal the example's recurrence and the JAX package's read of the same file
exactly (tolerance 0: the codec is lossless). Skips only where
``tests/test_c_example.py`` skips: without a C compiler or a system
libhdf5 runtime.
"""

from __future__ import annotations

import h5py
import numpy as np
import pytest

import c_example
from deltarice_tpu import h5 as jh5
from deltarice_tpu_torch import h5 as th5
from deltarice_tpu_torch import native


@pytest.fixture(scope="module")
def example_binary(tmp_path_factory):
    tools = c_example.toolchain()
    if tools is None:
        pytest.skip("needs a C compiler and a system libhdf5 runtime")
    out = tmp_path_factory.mktemp("cexample") / "dr_roundtrip"
    return c_example.build_example(*tools, out)


def test_example_links_the_port_library(example_binary):
    needed = example_binary.read_bytes()
    assert native.library_path().name.encode() in needed
    assert b"libh5deltarice_tpu.so" not in needed


def test_c_example_roundtrips(example_binary, tmp_path):
    h5file = tmp_path / "c_written.h5"
    out = c_example.write_file(example_binary, h5file)
    assert "round-trip OK" in out
    assert h5file.is_file()


def test_c_written_file_read_by_the_port(example_binary, tmp_path):
    h5file = tmp_path / "c_written.h5"
    c_example.write_file(example_binary, h5file)
    data = c_example.example_data()
    with h5py.File(h5file, "r") as f:
        dset = f["waveforms"]
        assert dset.compression is None  # custom filter, not a named one
        got = th5.read_dataset(dset, device="cpu")
        want = jh5.read_dataset(dset)
    assert got.dtype == np.int16 and got.shape == data.shape
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(got, want)
