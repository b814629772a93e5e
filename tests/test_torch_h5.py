"""The port's HDF5 layer (``deltarice_tpu_torch.h5``), filter plugin and CLI
against the JAX package's and the native plugin's, on the CPU.

Inputs are made from seeds with numpy and go through both packages with
``device="cpu"`` on the port's side (the kernels' plain versions); stored
chunk blobs must be byte-identical and decoded samples equal (tolerance 0:
the codec is integer and lossless).
"""

import json
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import deltarice_tpu as drt
from deltarice_tpu import cli as jcli
from deltarice_tpu import h5 as jh5
from deltarice_tpu_torch import cli as tcli
from deltarice_tpu_torch import h5 as th5
from deltarice_tpu_torch.config import H5FILTER, RiceConfig

h5py = pytest.importorskip("h5py")

REPO = Path(__file__).resolve().parent.parent
READER = REPO / "examples" / "c" / "dr_plugin_read.c"


def _data(shape, seed=0, sigma=10):
    rng = np.random.default_rng(seed)
    return np.round(np.cumsum(rng.normal(0, sigma, shape),
                              axis=-1)).astype(np.int16)


def _blobs(path, name="d"):
    """(offset, filter mask, stored bytes) of every chunk, in grid order."""
    with h5py.File(path, "r") as f:
        dset = f[name]
        return [(off, *dset.id.read_direct_chunk(off))
                for _i, off in th5._chunk_grid(dset.shape, dset.chunks)]


# 2-D with an edge chunk on the row axis; 1-D and 3-D with edge chunks on
# every axis (whole-chunk segments where the waveform length is -1)
CASES = {
    "2d": ((37, 500), (8, 500), (8, 500, (1, -1))),
    "1d": ((5000,), (1536,), (8, -1, (1, -1))),
    "3d": ((5, 6, 300), (2, 4, 300), (16, 300, (1, -2, 1))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_written_blobs_equal_the_jax_package(tmp_path, case):
    shape, chunks, (m, length, filt) = CASES[case]
    x = _data(shape, seed=len(shape))
    with h5py.File(tmp_path / "j.h5", "w") as f:
        jh5.write_dataset(f, "d", x, drt.RiceConfig(m, length, filt), chunks)
    with h5py.File(tmp_path / "t.h5", "w") as f:
        th5.write_dataset(f, "d", x, RiceConfig(m, length, filt), chunks,
                          device="cpu")
    want, got = _blobs(tmp_path / "j.h5"), _blobs(tmp_path / "t.h5")
    assert len(got) == len(want) > 1
    assert got == want
    with h5py.File(tmp_path / "t.h5", "r") as f:
        np.testing.assert_array_equal(th5.read_dataset(f["d"], device="cpu"),
                                      x)


def test_windowed_write_equals_one_window(tmp_path):
    x = _data((70, 300), seed=5)
    cfg = RiceConfig(8, 300)
    for name, batch in (("w.h5", 3), ("one.h5", 1000)):
        with h5py.File(tmp_path / name, "w") as f:
            th5.write_dataset(f, "d", x, cfg, (4, 300), batch_chunks=batch,
                              device="cpu")
    assert _blobs(tmp_path / "w.h5") == _blobs(tmp_path / "one.h5")
    with h5py.File(tmp_path / "w.h5", "r") as f:
        got = np.concatenate([b for _o, b in th5.iter_chunks(
            f["d"], batch_chunks=3, device="cpu")])
    np.testing.assert_array_equal(got[:70], x)
    assert not got[70:].any()  # the edge chunk's zero padding


def test_reads_a_jax_written_file(tmp_path):
    x = _data((21, 400), seed=6)
    with h5py.File(tmp_path / "j.h5", "w") as f:
        jh5.write_dataset(f, "d", x, drt.RiceConfig(4, 400), (5, 400))
    with h5py.File(tmp_path / "j.h5", "r") as f:
        assert th5.dataset_config(f["d"]) == RiceConfig(4, 400)
        np.testing.assert_array_equal(
            th5.read_dataset(f["d"], batch_chunks=2, device="cpu"), x)


def test_reads_plain_h5py_plugin_file_with_a_skipped_chunk(tmp_path):
    import deltarice_tpu_torch.register as reg

    x = _data((24, 256), seed=7)
    cfg = RiceConfig(8, 256)
    with h5py.File(tmp_path / "p.h5", "w") as f:
        dset = f.create_dataset("d", data=x, chunks=(8, 256),
                                compression=reg.H5FILTER,
                                compression_opts=cfg.to_cd_values())
        # a chunk stored raw with the filter marked skipped
        x[8:16] = _data((8, 256), seed=8)
        dset.id.write_direct_chunk((8, 0), x[8:16].tobytes(), filter_mask=1)
    with h5py.File(tmp_path / "p.h5", "r") as f:
        masks = [m for _o, m, _b in _blobs(tmp_path / "p.h5")]
        assert masks == [0, 1, 0]
        np.testing.assert_array_equal(th5.read_dataset(f["d"], device="cpu"),
                                      x)
        np.testing.assert_array_equal(f["d"][...], x)  # through the plugin


def test_plain_h5py_reads_a_port_written_file(tmp_path):
    import deltarice_tpu_torch.register as reg

    assert reg.H5FILTER == H5FILTER == 32025
    x = _data((19, 333), seed=9)
    with h5py.File(tmp_path / "t.h5", "w") as f:
        th5.write_dataset(f, "d", x, RiceConfig(16, 333), (4, 333),
                          device="cpu")
    with h5py.File(tmp_path / "t.h5", "r") as f:
        np.testing.assert_array_equal(f["d"][...], x)


def test_both_plugins_register_in_one_process():
    # filter 32025 from the JAX package's library and from the port's: each
    # registration replaces the class and succeeds
    assert th5.register_h5_filter()
    assert jh5.register_h5_filter()
    assert th5.register_h5_filter()


@pytest.mark.parametrize("cd", [(), (8,), (32, 7000), (8, 500, 3, 1, -2, 1),
                                (1 << 15, -1, 1, 1)], ids=str)
def test_dataset_config_round_trips_cd_values(tmp_path, cd):
    cfg = RiceConfig.from_cd_values(cd)
    with h5py.File(tmp_path / "c.h5", "w") as f:
        th5.create_dataset(f, "d", (4, 500), cfg, chunks=(2, 500))
    with h5py.File(tmp_path / "c.h5", "r") as f:
        got = th5.dataset_config(f["d"])
        assert got == cfg
        assert (got.to_cd_values() == jh5.dataset_config(f["d"]).to_cd_values()
                == drt.RiceConfig.from_cd_values(cd).to_cd_values())
        assert th5._deltarice_filter_bit(f["d"]) == 1


def test_write_dataset_verify(tmp_path, monkeypatch):
    x = _data((16, 200), seed=10)
    cfg = RiceConfig(8, 200)
    with h5py.File(tmp_path / "v.h5", "w") as f:
        th5.write_dataset(f, "d", x, cfg, (4, 200), batch_chunks=2,
                          verify=True, device="cpu")
    with h5py.File(tmp_path / "v.h5", "r") as f:
        np.testing.assert_array_equal(th5.read_dataset(f["d"], device="cpu"),
                                      x)
    # a verify failure mid-pipeline raises before the window is written
    from deltarice_tpu_torch import codec

    monkeypatch.setattr(codec, "decompress_batch",
                        lambda blobs, c, d: [np.zeros(1, np.int16)] * len(blobs))
    monkeypatch.setattr(codec, "decompress",
                        lambda b, c, d: np.zeros(1, np.int16))
    with h5py.File(tmp_path / "bad.h5", "w") as f:
        with pytest.raises(RuntimeError, match="verification"):
            th5.write_dataset(f, "d", x, cfg, (4, 200), batch_chunks=2,
                              verify=True, device="cpu")


def test_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    x = _data((8, 100))
    with h5py.File(tmp_path / "n.h5", "w") as f:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            th5.write_dataset(f, "d", x, RiceConfig(8, 100), (4, 100))
        th5.write_dataset(f, "e", x, RiceConfig(8, 100), (4, 100),
                          device="cpu")
        with pytest.raises(RuntimeError, match="no CUDA card"):
            th5.read_dataset(f["e"])


def test_default_plugin_dir_env(monkeypatch, tmp_path):
    from deltarice_tpu_torch.native.install import default_plugin_dir

    monkeypatch.setenv("HDF5_PLUGIN_PATH", f"{tmp_path}:/elsewhere")
    assert default_plugin_dir() == tmp_path
    monkeypatch.delenv("HDF5_PLUGIN_PATH")
    assert str(default_plugin_dir()).endswith("hdf5/lib/plugin")


def test_install_plugin_copies_library(tmp_path):
    from deltarice_tpu_torch import native
    from deltarice_tpu_torch.native.install import install_plugin

    dest = install_plugin(tmp_path / "plugins")
    assert dest.is_file() and dest.parent == tmp_path / "plugins"
    assert dest.read_bytes() == native.LIB.read_bytes()


def _system_hdf5():
    for pat in ("/usr/lib/*/libhdf5_serial.so*", "/usr/lib/*/libhdf5.so*",
                "/usr/lib64/libhdf5.so*"):
        hits = sorted(Path("/").glob(pat.lstrip("/")))
        if hits:
            return str(hits[0])
    return None


def test_c_reader_loads_the_installed_plugin(tmp_path):
    """A C program with no filter code reads a port-written file through
    ``HDF5_PLUGIN_PATH`` and the installed plugin."""
    from deltarice_tpu_torch.native.install import install_plugin

    cc = shutil.which("cc") or shutil.which("gcc")
    hdf5 = _system_hdf5()
    if cc is None or hdf5 is None:
        pytest.skip("needs a C compiler and a system libhdf5 runtime")
    plugin_dir = tmp_path / "plugins"
    install_plugin(plugin_dir)
    data = _data((64, 512), seed=11, sigma=8)
    with h5py.File(tmp_path / "t.h5", "w") as f:
        th5.write_dataset(f, "waveforms", data, RiceConfig(8, 512), (16, 512),
                          device="cpu")
    reader = tmp_path / "dr_plugin_read"
    subprocess.run([cc, str(READER), "-I", str(READER.parent), "-o",
                    str(reader), hdf5], check=True, capture_output=True)
    res = subprocess.run([str(reader), str(tmp_path / "t.h5"), "waveforms",
                          str(data.size)], capture_output=True, text=True,
                         env={"HDF5_PLUGIN_PATH": str(plugin_dir)})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == f"sum={int(data.astype(np.int64).sum())}"


def test_cli_matches_the_jax_cli(tmp_path, capsys):
    x = _data((40, 600), seed=12)
    src = tmp_path / "src.h5"
    with h5py.File(src, "w") as f:
        f.create_dataset("w", data=x, chunks=(10, 600))

    def run(main, *argv):
        main([str(a) for a in argv])
        return capsys.readouterr().out

    run(jcli.main, "compress", src, tmp_path / "j.h5", "--chunk-rows", 16)
    run(tcli.main, "compress", src, tmp_path / "t.h5", "--chunk-rows", 16,
        "--device", "cpu")
    assert _blobs(tmp_path / "t.h5", "w") == _blobs(tmp_path / "j.h5", "w")
    assert (run(tcli.main, "info", tmp_path / "t.h5")
            == run(jcli.main, "info", tmp_path / "j.h5"))
    run(tcli.main, "decompress", tmp_path / "j.h5", tmp_path / "d.h5",
        "--device", "cpu")
    with h5py.File(tmp_path / "d.h5", "r") as f:
        np.testing.assert_array_equal(f["w"][...], x)
    for taps in ("2", "3"):
        got = json.loads(run(tcli.main, "optimize", src, "--taps", taps,
                             "--device", "cpu"))
        want = json.loads(run(jcli.main, "optimize", src, "--taps", taps))
        assert got == want
