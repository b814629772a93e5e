"""The port's fuzz, profiling and scaling tools on the CPU at small sizes,
against the JAX package's ``tools/*.py`` and their artifacts
(``SCALING.json``, ``SCALING_CHIP.json``), and every new tool module's
import and device check.

The fuzz's draws must equal ``tools/fuzz_oracle.py``'s for the same seed,
and every check against the native codec must hold (tolerance 0).
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import deltarice_tpu as drt
from deltarice_tpu_torch.ops import prefilter_model
from deltarice_tpu_torch.tools import (fuzz_native, iir_blocks, profile_stages,
                                       scaling_bench, singlechip_scaling)

REPO = Path(__file__).resolve().parent.parent
MODULES = ["bench", "tools", "tools.memstore", "tools.bench_geometries",
           "tools.bench_file", "tools.fuzz_native", "tools.profile_stages",
           "tools.singlechip_scaling", "tools.scaling_bench",
           "tools.iir_blocks"]
# each tool's command line without --device: it must refuse to run
TOOL_ARGV = {
    "tools.bench_geometries": ["--rows", "2"],
    "tools.bench_file": ["--store", "memory", "--rows", "2"],
    "tools.fuzz_native": ["1"],
    "tools.profile_stages": ["4", "7000", "8"],
    "tools.singlechip_scaling": ["--store", "memory"],
    "tools.scaling_bench": ["--devices", "1"],
    "tools.iir_blocks": ["--samples", "512"],
}


def _covers(port: dict, jax: dict, dropped) -> None:
    """Every key of ``jax`` less ``dropped`` is one of ``port``'s, and so
    for the dicts under them and the first row of ``rows``."""
    for k, v in jax.items():
        if k in dropped:
            continue
        assert k in port, f"key {k!r} of the JAX output missing"
        if isinstance(v, dict):
            _covers(port[k], v, dropped)
        elif k == "rows":
            _covers(port[k][0], v[0], dropped)


def test_fuzz_draws_equal_the_jax_tools():
    spec = importlib.util.spec_from_file_location(
        "jax_tool_fuzz_oracle", REPO / "tools" / "fuzz_oracle.py")
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    for seed in (0, 1):
        ours, theirs = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(60):
            x, cfg = fuzz_native.random_case(ours)
            jx, jcfg = jtool.random_case(theirs)
            np.testing.assert_array_equal(x, jx)
            assert (cfg.m, cfg.waveform_length, tuple(cfg.filt)) == (
                jcfg.m, jcfg.waveform_length, tuple(jcfg.filt))


def test_fuzz_twenty_cases_hold_against_the_native_codec(monkeypatch):
    monkeypatch.delenv(fuzz_native.SPLIT_ENV, raising=False)
    rep = fuzz_native.run(20, 0, "cpu")
    assert rep["failures"] == 0, rep["failed"]
    assert rep["cases"] == 20 and rep["card"] is None
    assert fuzz_native.SPLIT_ENV not in __import__("os").environ


def test_fuzz_counts_a_corrupted_stream(monkeypatch, capsys):
    real = fuzz_native.compress

    def corrupted(data, cfg, device):
        blob = bytearray(real(data, cfg, device))
        blob[-1] ^= 0x40
        return bytes(blob)

    monkeypatch.setattr(fuzz_native, "compress", corrupted)
    assert fuzz_native.main(["1", "0", "--device", "cpu"]) == 1
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("FAIL case 0 split off")
    assert json.loads(out[-1])["failures"] == 2


def test_profile_stages_on_the_cpu():
    rep = profile_stages.run(4, 7000, 8, iters=1, reps=1, device="cpu")
    assert set(rep["host"]) == {"_padded_rows", "_words_hint",
                                "frame_stream", "walk_headers",
                                "gather_segments"}
    assert set(rep["device"]) == {"encode", "decode"}
    assert rep["passes"] is None and rep["copies"] is None
    x = profile_stages.make_data(4, 7000)
    assert rep["ratio"] == len(drt.compress(x, drt.RiceConfig(8, 7000))) \
        / x.nbytes


def test_iir_blocks_on_the_cpu(capsys):
    """The block-length sweep of the generic inverse on the plain model:
    every case at every length, and the length the shape chooses."""
    assert iir_blocks.main(["--device", "cpu", "--samples", "1024",
                            "--blocks", "256,512"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["platform"] == "cpu" and rep["card"] is None
    assert [c["case"] for c in rep["cases"]] == [
        "nab", "noptrex bucket", "noptrex chunk"]
    for c in rep["cases"]:
        assert sorted(c["ms"]) == ["256", "512"]
        assert all(v > 0 for v in c["ms"].values())
        assert c["fastest"] in (256, 512)
        assert c["chosen"] == prefilter_model.choose_block(*c["shape"])


def test_singlechip_scaling_keys():
    rep = singlechip_scaling.run(64, 1024, 2, store="memory", iters=1,
                                 reps=2, device="cpu")
    _covers(rep, json.loads((REPO / "SCALING_CHIP.json").read_text()),
            singlechip_scaling.DROPPED)
    m1 = rep["mesh_of_one"]
    assert m1["chunks"] == [2, 32, 1024]
    assert m1["enc_overhead"] == m1["mesh1_enc_ms"] / m1["plain_enc_ms"] - 1
    assert rep["pipeline"]["write_device_utilization"] is None
    assert rep["d2h_MBps"] is None and rep["card"] is None


def test_scaling_bench_over_two_gloo_ranks():
    rep = scaling_bench.run((1, 2), nseg=8, length=1024, chunks_per_dev=2,
                            iters=1, reps=1, device="cpu")
    _covers(rep, json.loads((REPO / "SCALING.json").read_text()),
            scaling_bench.DROPPED)
    assert [r["devices"] for r in rep["rows"]] == [1, 2]
    assert rep["rows"][0]["efficiency"] == 1.0
    assert rep["rows"][1]["rank_devices"] == ["cpu", "cpu"]
    assert rep["backend"] == "gloo" and rep["per_device_batch"] == [2, 8, 1024]


def _children() -> set[str]:
    """The process ids of this process's children, zombies included."""
    task = Path(f"/proc/{os.getpid()}/task")
    return {pid for t in task.iterdir()
            for pid in (t / "children").read_text().split()}


def test_scaling_bench_leaves_no_process_behind():
    before = _children()
    rep = scaling_bench.run((1,), nseg=4, length=256, chunks_per_dev=1,
                            iters=1, reps=1, device="cpu")
    assert [r["devices"] for r in rep["rows"]] == [1]
    assert _children() <= before


@pytest.mark.parametrize("module", MODULES)
def test_tool_module_imports_neither_jax_nor_the_jax_package(module):
    code = (f"import sys, deltarice_tpu_torch.{module}; "
            f"print(sorted(m for m in sys.modules "
            f"if m.split('.')[0] in ('jax', 'deltarice_tpu')))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


@pytest.mark.parametrize("module", sorted(TOOL_ARGV))
def test_tool_needs_a_card_unless_asked_for_the_cpu(module, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    mod = importlib.import_module(f"deltarice_tpu_torch.{module}")
    assert mod.main(TOOL_ARGV[module]) == 2
    assert "CUDA card" in capsys.readouterr().err
