"""The port's native library against the JAX package's ``native`` module:
the public names (``library_path``, ``is_built``, ``build(verbose=)``), the
staleness check over every ``src/*.[ch]``, and the wheel build
(``setup.py``'s ``build_py`` hook prebuilds both packages' filter
libraries).

The staleness cases run on a scratch tree that both modules are pointed at
by monkeypatching (the port's ``LIB`` / ``SRC_DIR``, the JAX module's
``__file__`` and ``_build._LIB``), so no file of the repository is touched.
"""

from __future__ import annotations

import ctypes
import inspect
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from deltarice_tpu import native as jnative
from deltarice_tpu.native import _build as jbuild
from deltarice_tpu_torch import native
from deltarice_tpu_torch.native import __main__ as native_main

REPO = Path(__file__).resolve().parent.parent
PUBLIC = ("library_path", "is_built", "build")


@pytest.mark.parametrize("name", PUBLIC)
def test_public_names_are_the_jax_modules(name):
    port, jax = getattr(native, name), getattr(jnative, name)
    assert inspect.signature(port) == inspect.signature(jax)
    assert not hasattr(native, "_is_built")


def _tree(tmp_path: Path) -> tuple[Path, Path]:
    """A scratch ``src/`` (copies of the port's sources) and a library path
    beside it."""
    src = tmp_path / "pkg" / "src"
    shutil.copytree(native.SRC_DIR, src)
    return src, tmp_path / "pkg" / "lib" / "libscratch.so"


def _stamp(path: Path, t: float) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    if not path.exists():
        path.write_bytes(b"\0")
    os.utime(path, (t, t))


# each case: files to stamp after the sources (all at t = 1000), in order,
# and whether the library then counts as built
STALENESS = {
    "no library": ([], False),
    "library newer": ([("lib", 2000)], True),
    "header touched": ([("lib", 2000), ("src/dr_codec.h", 3000)], False),
    "plugin source touched": ([("lib", 2000), ("src/h5z_deltarice.c", 3000)],
                              False),
    "new header": ([("lib", 2000), ("src/dr_extra.h", 3000)], False),
    "rebuilt after": ([("src/dr_codec.h", 3000), ("lib", 4000)], True),
    "same second": ([("lib", 1000)], True),
}


@pytest.mark.parametrize("case", STALENESS, ids=str)
def test_is_built_is_the_jax_check(case, tmp_path, monkeypatch):
    src, lib = _tree(tmp_path)
    for p in src.glob("*.[ch]"):
        _stamp(p, 1000)
    stamps, want = STALENESS[case]
    for name, t in stamps:
        _stamp(lib if name == "lib" else src.parent / name, t)
    monkeypatch.setattr(native, "LIB", lib)
    monkeypatch.setattr(native, "SRC_DIR", src)
    monkeypatch.setattr(jnative, "__file__", str(src.parent / "__init__.py"))
    monkeypatch.setattr(jbuild, "_LIB", lib)
    assert native.library_path() == jnative.library_path() == lib
    assert native.is_built() is jnative.is_built() is want


def test_build_writes_library_path(capfd):
    path = native.build(verbose=True)
    capfd.readouterr()
    assert path == native.library_path() == native.LIB
    assert native.is_built()
    lib = ctypes.CDLL(str(path))
    for symbol in ("dr_compress", "dr_decompress", "deltarice_tpu_register",
                   "H5PLget_plugin_info"):
        assert hasattr(lib, symbol), symbol


def test_native_main_builds_verbosely(capsys):
    assert native_main.main(["build", "-v"]) == 0
    assert capsys.readouterr().out.strip() == f"built {native.library_path()}"


def test_ensure_built_keeps_a_prebuilt_library_without_a_compiler(
        tmp_path, monkeypatch):
    """A wheel's prebuilt library unpacked before its sources looks stale;
    without a compiler it is used as it is, and its absence raises."""
    src, lib = _tree(tmp_path)
    _stamp(lib, 1000)
    for p in src.glob("*.[ch]"):
        _stamp(p, 2000)
    monkeypatch.setattr(native, "LIB", lib)
    monkeypatch.setattr(native, "SRC_DIR", src)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    assert not native.is_built()
    assert native.ensure_built() == lib
    lib.unlink()
    with pytest.raises(native.NoCompiler):
        native.ensure_built()


def test_setup_build_py_prebuilds_both_filter_libraries(tmp_path):
    """``python setup.py build_py --build-lib OUT`` leaves both packages'
    filter libraries under OUT, and not the kernels' libraries. It runs in a
    copy of the packaging files and both packages, since the JAX hook
    rebuilds its library in place, under other tests that load it."""
    tree = tmp_path / "tree"
    skip = shutil.ignore_patterns("__pycache__", "build", "lib", "*.so")
    for name in ("deltarice_tpu", "deltarice_tpu_torch"):
        shutil.copytree(REPO / name, tree / name, ignore=skip)
    for name in ("setup.py", "pyproject.toml", "README.md"):
        shutil.copy2(REPO / name, tree / name)
    out = tmp_path / "out"
    res = subprocess.run(
        [sys.executable, "setup.py", "-q", "build_py", "--build-lib",
         str(out)], cwd=tree, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "not prebuilt" not in res.stderr
    built = sorted(p.relative_to(out).as_posix() for p in out.rglob("*.so"))
    assert built == [
        "deltarice_tpu/native/lib/libh5deltarice_tpu.so",
        "deltarice_tpu_torch/build/native/libh5deltarice_tpu_torch.so"]
    lib = ctypes.CDLL(str(out / built[1]))
    assert hasattr(lib, "deltarice_tpu_register")
    assert (out / "deltarice_tpu_torch/tools/baselines/BENCH_r01.json"
            ).is_file()
