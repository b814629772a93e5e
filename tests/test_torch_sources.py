"""The port's own copy of the native C sources.

``deltarice_tpu_torch/native/src/`` holds the JAX package's C sources byte
for byte, the port's native library builds from there, and no module of
the port, nor ``chip_smoke.py``, builds from or opens a path under
``deltarice_tpu/``. Strings that name a counterpart's file and line
(``"deltarice_tpu/ops/transpose_pallas.py:21"``), comments and
docstrings are left out of the search; so are the module names
``chip_smoke.py`` and the examples look up in ``sys.modules``.
"""

import ast
import re
from pathlib import Path

import pytest

from deltarice_tpu_torch import native

ROOT = Path(__file__).resolve().parents[1]
JAX_SRC = ROOT / "deltarice_tpu" / "native" / "src"
PORT = ROOT / "deltarice_tpu_torch"
PORT_SRC = PORT / "native" / "src"
# "file:line" (or "file::function") of a counterpart: a name, not a path
# that is opened
REFERENCE = re.compile(r"^deltarice_tpu/[\w/]+\.py(:\d+|::\w+)$")


def test_native_sources_are_copies_of_the_jax_packages():
    names = sorted(p.name for p in JAX_SRC.iterdir() if p.is_file())
    assert names == sorted(p.name for p in PORT_SRC.iterdir() if p.is_file())
    for name in names:
        assert (PORT_SRC / name).read_bytes() == (JAX_SRC / name).read_bytes()


def test_native_library_builds_from_the_ports_sources():
    assert native.SRC_DIR.resolve() == PORT_SRC
    assert native.SOURCES
    for src in native.SOURCES:
        assert src.resolve().parent == PORT_SRC and src.is_file()


def _code_strings(path: Path):
    """(line, value, joined) of every string constant of the code that is
    not a docstring (nor another bare string statement); joined: the
    string is an operand of ``/`` or an argument of a path join."""
    tree = ast.parse(path.read_text())
    parents = {child: node for node in ast.walk(tree)
               for child in ast.iter_child_nodes(node)}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Constant) and isinstance(node.value, str)):
            continue
        parent = parents.get(node)
        if isinstance(parent, ast.Expr):
            continue
        joined = isinstance(parent, ast.BinOp) and isinstance(parent.op, ast.Div)
        if isinstance(parent, ast.Call):
            fn = parent.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", "")
            joined = name in ("join", "joinpath", "Path", "PurePath")
        yield node.lineno, node.value, joined


def _into_jax_package(value: str, joined: bool) -> bool:
    if value == "deltarice_tpu":
        return joined
    return ("deltarice_tpu/" in value or "deltarice_tpu\\" in value) and \
        not REFERENCE.match(value)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_port_code_opens_the_jax_package():
    found = [(path.name, line, value) for path in _port_files()
             for line, value, joined in _code_strings(path)
             if _into_jax_package(value, joined)]
    assert found == []


@pytest.mark.parametrize("pattern", [
    '_PKG.parent / "deltarice_tpu"', 'Path("deltarice_tpu/native/src")',
    'open("deltarice_tpu/native/src/dr_codec.c")',
    'os.path.join(ROOT, "deltarice_tpu", "native")',
])
def test_the_search_finds_a_path_into_the_jax_package(tmp_path, pattern):
    """The search above is not blind: each pattern, written as code, is
    found."""
    src = tmp_path / "mod.py"
    src.write_text(f'"""Doc."""\n\nSRC = {pattern}\n')
    assert any(_into_jax_package(v, j) for _l, v, j in _code_strings(src))


def test_the_search_leaves_out_references_and_docstrings(tmp_path):
    src = tmp_path / "mod.py"
    src.write_text('"""Reads ``deltarice_tpu/native/src/`` (doc)."""\n\n'
                   '# deltarice_tpu/native/src in a comment\n'
                   'REPLACES = "deltarice_tpu/ops/transpose_pallas.py:21"\n'
                   'JAX = "deltarice_tpu" in {}\n')
    strings = [(v, j) for _l, v, j in _code_strings(src)]
    assert sorted(strings) == [
        ("deltarice_tpu", False),
        ("deltarice_tpu/ops/transpose_pallas.py:21", False)]
    assert not any(_into_jax_package(v, j) for v, j in strings)
