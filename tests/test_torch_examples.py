"""The port's runnable entry points on the CPU: ``python -m
deltarice_tpu_torch.native build|install`` and the HDF5 examples with
``--device cpu``, each in a temporary working directory (needs h5py)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(args, cwd):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    res = subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def test_native_main_builds_the_plugin(tmp_path):
    from deltarice_tpu_torch.native import LIB

    out = _run(["deltarice_tpu_torch.native", "build"], tmp_path)
    assert out.strip() == f"built {LIB}" and LIB.is_file()


def test_native_main_installs_into_a_plugin_dir(tmp_path):
    from deltarice_tpu_torch.native import LIB

    plugins = tmp_path / "plugins"
    out = _run(["deltarice_tpu_torch.native", "install", "--plugin-dir",
                str(plugins)], tmp_path)
    assert out.strip() == f"installed {plugins / LIB.name}"
    assert (plugins / LIB.name).read_bytes() == LIB.read_bytes()


@pytest.mark.parametrize("name,written", [("basic_roundtrip", "testFile.h5"),
                                          ("native_plugin", "native.h5")])
def test_example_runs_on_the_cpu(tmp_path, name, written):
    pytest.importorskip("h5py")
    out = _run([f"deltarice_tpu_torch.examples.{name}", "--device", "cpu"],
               tmp_path)
    assert out.startswith("ok:") and "on cpu" in out
    assert (tmp_path / written).is_file()
