"""The port's measurement tools (``deltarice_tpu_torch.bench``,
``deltarice_tpu_torch.tools``) against the JAX package's ``bench.py`` and
``tools/*.py``, on the CPU at small sizes.

The JAX tools are imported from the repository by path, as the JAX tests
import the JAX package on the CPU. Data generators must draw the same
samples, configs must match, and compressed sizes must equal the JAX
package's ``compress`` on the same inputs exactly (tolerance 0: the codec
is integer and lossless). Output keys must cover the JAX artifacts' keys
less the ones each tool lists as TPU-only (``DROPPED``).
"""

import hashlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import deltarice_tpu as drt
from deltarice_tpu import codec as jcodec
from deltarice_tpu_torch import bench, codec
from deltarice_tpu_torch.config import RiceConfig
from deltarice_tpu_torch.native import native_compress
from deltarice_tpu_torch.tools import bench_file, bench_geometries

REPO = Path(__file__).resolve().parent.parent
LONG = ("nedm", "noptrex")


def _jax_tool(name: str):
    """``tools/<name>.py`` of the JAX package, imported by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _keys(obj, prefix="") -> set:
    """Dotted key paths of nested dicts (lists are leaves)."""
    out = set()
    for k, v in obj.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def _covers(port: dict, jax: dict, dropped, renamed=None) -> None:
    """Every key path of ``jax`` less ``dropped`` names (and with
    ``renamed`` names replaced) is one of ``port``'s."""
    renamed = renamed or {}
    want = set()
    for path in _keys(jax):
        parts = path.split(".")
        if any(p in dropped for p in parts):
            continue
        want.add(".".join(renamed.get(p, p) for p in parts))
    missing = want - _keys(port)
    assert not missing, f"keys of the JAX output missing: {sorted(missing)}"


def _jax_size(x: np.ndarray, m: int, length: int, filt=(1, -1)) -> int:
    return len(drt.compress(x, drt.RiceConfig(m, length, filt)))


# --- bench_geometries ----------------------------------------------------

def test_geometry_configs_are_the_jax_tools(monkeypatch):
    jtool = _jax_tool("bench_geometries")
    calls = []

    def record(kind, shape, sigma, seed=0):
        calls.append((kind, tuple(shape), sigma, seed))
        return np.zeros((1, shape[1]), np.int16)

    monkeypatch.setattr(jtool, "make_data", record)
    assert list(jtool.CONFIGS) == list(bench_geometries.CONFIGS)
    for name, (parts, m, length) in bench_geometries.CONFIGS.items():
        calls.clear()
        _x, cfg = jtool.CONFIGS[name]()
        assert (cfg.m, cfg.waveform_length, tuple(cfg.filt)) == (
            m, length, (1, -1))
        assert calls == [(kind, (n, length), sigma, 0)
                         for kind, n, sigma in parts]


@pytest.mark.parametrize("kind,sigma", [("walk", 10.0), ("walk", 4.0),
                                        ("uniform", 0.0)])
def test_geometry_make_data_equals_the_jax_tools(kind, sigma):
    jtool = _jax_tool("bench_geometries")
    for shape in ((4, 7000), (3, 81920)):
        np.testing.assert_array_equal(
            bench_geometries.make_data(kind, shape, sigma),
            jtool.make_data(kind, shape, sigma))


def test_geometry_rows_cut_the_segments_only():
    x, cfg = bench_geometries.make_config("mixed_dense1pct", 4)
    assert x.shape == (4, 7000) and (cfg.m, cfg.waveform_length) == (8, 7000)
    np.testing.assert_array_equal(
        x[:3], bench_geometries.make_data("uniform", (3, 7000), 0.0))
    np.testing.assert_array_equal(
        x[3:], bench_geometries.make_data("walk", (1, 7000), 10.0))
    full, _ = bench_geometries.make_config("nab")
    small, _ = bench_geometries.make_config("nab", 4)
    np.testing.assert_array_equal(small, full[:4])


@pytest.mark.parametrize("name", [n for n in bench_geometries.CONFIGS
                                  if n not in LONG])
def test_geometry_row_equals_jax_compress(name):
    """A short config's whole run at 4 rows: the round trip (checked inside
    the tool), its row's keys against GEOMETRY_BENCH.json's row, and its
    size against the JAX package's compress."""
    rep = bench_geometries.run([name], rows=4, iters=1, reps=1,
                               device="cpu")
    published = json.loads((REPO / "GEOMETRY_BENCH.json").read_text())
    jrow = next(r for r in published["rows"] if r["config"] == name)
    row = rep["rows"][0]
    _covers(row, jrow, bench_geometries.DROPPED)
    x, cfg = bench_geometries.make_config(name, 4)
    size = _jax_size(x, cfg.m, cfg.waveform_length)
    assert row["compressed_bytes"] == size
    assert row["ratio"] == round(size / x.nbytes, 3)
    assert rep["card"] is None and rep["platform"] == "cpu"


@pytest.mark.parametrize("name", LONG)
def test_long_geometry_size_equals_jax_compress(name):
    """nEDM and NOPTREX at 2 rows: the split encode and its merge (their
    decode on the CPU steps through every sample, so the tool's full run
    is left to the card)."""
    x, cfg = bench_geometries.make_config(name, 2)
    enc = bench_geometries.encode_config(x, cfg, 1, 1, "cpu")
    assert enc["parts"] == jcodec._split_parts(2, x.shape[1], cfg) > 1
    size = _jax_size(x, cfg.m, cfg.waveform_length)
    assert bench_geometries.compressed_bytes(enc["nwords"]) == size
    # the merged words frame into the JAX package's stream
    words = enc["words"].numpy().view(np.uint32)
    assert codec.frame_stream(x.size, words, enc["nwords"]) == \
        drt.compress(x, drt.RiceConfig(cfg.m, cfg.waveform_length))


def test_geometry_split_decode_branch(monkeypatch):
    """With the split switch on, a row reports the split decode's parts and
    flags (the router splits only batches of >= 1024 sub-rows, so the part
    count is forced); its encode splits and merges too."""
    monkeypatch.setenv("DELTARICE_TPU_SPLIT_DECODE", "1")
    monkeypatch.setattr(bench_geometries, "decode_split_parts",
                        lambda nseg, wmax, k: 2)
    x = bench_geometries.make_data("walk", (4, 20000), 8.0)
    row = bench_geometries.bench_config("walk", x, RiceConfig(8, 20000), 1,
                                        1, "cpu")
    assert row["split_decode"] and row["decode_split_parts"] == 2
    assert row["decode_flagged"] >= 0 and row["split_parts"] == 2
    assert row["compressed_bytes"] == _jax_size(x, 8, 20000)


def test_split_parts_equal_jax_at_the_full_shapes():
    for name, (parts, m, length) in bench_geometries.CONFIGS.items():
        nseg = sum(n for _k, n, _s in parts)
        cfg = drt.RiceConfig(m, length)
        assert codec._split_parts(nseg, length, cfg) == \
            jcodec._split_parts(nseg, length, cfg), name
    published = json.loads((REPO / "GEOMETRY_BENCH.json").read_text())
    for row in published["rows"]:
        nseg, length = row["shape"]
        assert codec._split_parts(nseg, length, drt.RiceConfig(
            row["m"], length)) == row.get("split_parts", 1)


# --- bench ---------------------------------------------------------------

def test_bench_runs_small_and_matches_the_jax_keys():
    rep = bench.run(nseg=4, iters=1, reps=1, device="cpu")
    parsed = json.loads((REPO / "BENCH_r05.json").read_text())["parsed"]
    _covers(rep, parsed, bench.DROPPED)
    d = rep["detail"]
    assert d["round_trip"] == "exact" and d["batch"] == [4, 7000]
    assert rep["card"] is None and d["platform"] == "cpu"
    assert rep["vs_baseline"] == rep["value"] / bench.BASELINE_GBPS
    x = bench.make_data(4)
    assert d["ratio"] == _jax_size(x, 8, 7000) / x.nbytes
    jbench_x = np.cumsum(np.round(np.random.default_rng(0).normal(
        0, 10, (4, 7000))), axis=-1).astype(np.int16)
    np.testing.assert_array_equal(x, jbench_x)  # bench.py:136-140


# --- bench_file ----------------------------------------------------------

@pytest.mark.parametrize("geom", sorted(bench_file.GEOMETRIES))
def test_file_make_data_equals_the_jax_tools(geom):
    jtool = _jax_tool("bench_file")
    assert jtool.GEOMETRIES[geom] == bench_file.GEOMETRIES[geom]
    np.testing.assert_array_equal(bench_file._make_data(geom, 0.0),
                                  jtool._make_data(geom, 0.0))


def test_file_stores_hold_the_native_bytes(tmp_path):
    pytest.importorskip("h5py")
    reps = {store: bench_file.run(geom="nab", store=store, rows=4, reps=1,
                                  workdir=str(tmp_path), device="cpu")
            for store in ("h5py", "memory")}
    x = bench_file._make_data("nab", 0.0)[:4]
    blob = native_compress(x, (8, 7000))
    want = (len(blob), hashlib.sha256(blob).hexdigest())
    assert len(blob) == _jax_size(x, 8, 7000)
    for store, rep in reps.items():
        assert rep["detail"]["store"] == store and rep["card"] is None
        g = rep["detail"]["geometries"]["nab"]
        assert g["chunk"] == [4, 7000]
        comps = ["torch_direct_chunk"] + (["native_plugin_omp"]
                                          if store == "h5py" else [])
        assert sorted(k for k in g if isinstance(g[k], dict)) == sorted(comps)
        for comp in comps:
            assert (g[comp]["stored_bytes"], g[comp]["stored_sha256"]) == want
            assert g[comp]["ratio"] == round(len(blob) / x.nbytes, 3)
    published = json.loads((REPO / "FILE_BENCH.json").read_text())
    published["detail"]["geometries"] = {
        "nab": published["detail"]["geometries"]["nab"]}
    _covers(reps["h5py"], published, bench_file.DROPPED, bench_file.RENAMED)


def test_file_store_is_chosen_explicitly(monkeypatch):
    with pytest.raises(ValueError):
        bench_file.run(geom="nab", store="hdf5", rows=4, device="cpu")
    with pytest.raises(SystemExit):
        bench_file.main(["--geom", "nab", "--device", "cpu"])
    monkeypatch.setitem(sys.modules, "h5py", None)  # h5py missing
    with pytest.raises(ImportError):
        bench_file.run(geom="nab", store="h5py", rows=4, device="cpu")


@pytest.mark.parametrize("argv", [
    ["--nseg", "4"], ["--file", "--store", "memory", "--geom", "nab"]])
def test_bench_needs_a_card_unless_asked_for_the_cpu(argv, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    assert bench.main(argv) == 2
    assert "CUDA card" in capsys.readouterr().err
