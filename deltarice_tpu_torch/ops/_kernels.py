"""Build and ctypes binding of the CUDA kernels in ``deltarice_tpu_torch/csrc``.

The sources have a plain C interface (``csrc/kernels.h``), so they compile
with ``nvcc`` alone, without PyTorch's headers: one ``nvcc -c`` per source,
all started together, then one link into a shared library under
``deltarice_tpu_torch/build/``. The file name carries a digest of the
sources and flags, so an edited source never loads a stale build. The
build runs at the first kernel launch of a process, never at import.

A second variant, the checked build, compiles the same sources with
:data:`CHECKED_FLAGS` (``csrc/smem_check.h``: every shared-memory access
held to its array, shared memory poisoned at kernel entry, the warp
schedule perturbed) into a library of its own name. Only
``deltarice_tpu_torch.testing.smem.install`` selects it, through
:func:`use_checked`, before the process's first launch.

Every pointer and the stream pass as ``c_void_p``; every entry point
returns ``cudaGetLastError()`` and :func:`check` raises on a nonzero value.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from collections import Counter
from pathlib import Path

import torch

from .. import tracing

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[1] / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]
#: added to NVCC_FLAGS for the checked build
CHECKED_FLAGS = ["-DDR_SMEM_CHECK=1", "-lineinfo"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int

_SIGNATURES = {
    "dr_transpose2d": [_P, _P, _I64, _I64, _I64, _I, _P],
    "dr_transpose_vector_path": [_P, _P, _I64, _I64, _I],
    "dr_transpose_geometry": [_I, _P],
    "dr_pack_encode": [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I,
                       _P],
    "dr_unpack_decode": [_P, _P, _P, _I64, _I64, _I64, _I64, _I, _I, _P,
                         _P],
    "dr_unpack_tables": [_P, _P, _I64, _I64, _I, _P],
    "dr_concentrate_packed": [_P, _P, _P, _I64, _I64, _I64, _P],
    "dr_concentrate_wide": [_P, _P, _P, _I64, _I64, _I64, _P],
    "dr_concentrate_wide16": [_P, _P, _I64, _I64, _I64, _P],
    "dr_concentrate_tiled": [_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I,
                             _I, _P, _P],
    "dr_concentrate_tiled_vd": [_P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                                _P, _P],
    "dr_split_decode": [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64,
                        _I, _I, _I, _P],
    "dr_iir_decode": [_P, _P, _P, _I64, _I, _I64, _I64, _P, _P],
    "dr_iir_blocked": [_P, _P, _P, _P, _P, _I64, _I, _I64, _I64, _I64, _P],
    "dr_fir_encode": [_P, _P, _P, _I64, _I64, _I64, _P],
}

#: scratch sizes the kernels' wrappers allocate: (length or words, nseg),
#: and (history taps, rows) for the generic inverse's global ring
_SIZES = ("dr_pack_scratch_words", "dr_unpack_scratch_bytes",
          "dr_iir_ring_bytes")

#: kernel launches per wrapper name, counted where each wrapper launches
#: its kernel and nowhere else
launches: Counter = Counter()

#: the tiles that B2's check walked again, one int64 scalar per device that
#: the kernels add to and only ``tracing.snapshot()`` reads
tiles_rejoined: dict = {}

_lib: ctypes.CDLL | None = None
_checked = False  # this process loads the checked build (use_checked)


def reset_launches() -> None:
    launches.clear()


def rejoined_counter(device: torch.device) -> torch.Tensor:
    """The :data:`tiles_rejoined` scalar of ``device``, made (zero) on first
    use."""
    counter = tiles_rejoined.get(device)
    if counter is None:
        counter = tiles_rejoined[device] = torch.zeros(
            (), dtype=torch.int64, device=device)
    return counter


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.h"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").is_file():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _flags(checked: bool) -> list[str]:
    return NVCC_FLAGS + (CHECKED_FLAGS if checked else [])


def library_path(checked: bool = False) -> Path:
    """The library of the default build, or of the checked build."""
    h = hashlib.sha256(" ".join(_flags(checked)).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    kind = "kernels_checked" if checked else "kernels"
    return BUILD / f"libdr_{kind}_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False, checked: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` into one shared library (idempotent;
    atomic replace, so a concurrent process never loads a partial file)."""
    lib = library_path(checked)
    if lib.is_file():
        return lib
    with tracing.span("build"):
        return compile_library(CSRC, _flags(checked), lib, verbose)


def compile_library(csrc: Path, flags: list[str], lib: Path,
                    verbose: bool = False) -> Path:
    """Compile every ``*.cu`` of ``csrc`` with ``flags`` into ``lib``, one
    ``nvcc`` process a source, all started together, then one link."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmpdir:
        objs, procs = [], []
        for src in sorted(Path(csrc).glob("*.cu")):
            obj = os.path.join(tmpdir, src.stem + ".o")
            objs.append(obj)
            procs.append((src.name, subprocess.Popen(
                [nvcc, *flags, *ptxas, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for name, proc in procs:
            out = proc.communicate()[0]
            if verbose or proc.returncode != 0:
                print(f"nvcc {name}:\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}")
        tmp = os.path.join(tmpdir, "lib.so")
        res = subprocess.run([nvcc, *flags, "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr)
            raise RuntimeError(f"nvcc link failed (rc={res.returncode})")
        os.replace(tmp, lib)
    return lib


def use_checked() -> None:
    """Load the checked build in place of the default one (see the module
    docstring): before this process's first launch, which loads a
    library; raises where the default build is loaded already."""
    global _checked
    if _lib is not None and not _checked:
        raise RuntimeError("the default kernels are loaded already: the "
                           "checked build must be chosen before the first "
                           "launch")
    _checked = True


def library() -> ctypes.CDLL:
    """The kernels' library, built and loaded on first use."""
    global _lib
    if _lib is None:
        with tracing.span("load"):
            lib = ctypes.CDLL(str(build(checked=_checked)))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            for name in _SIZES:
                fn = getattr(lib, name)
                fn.argtypes = [_I64, _I64]
                fn.restype = _I64
            if _checked:
                lib.dr_smem_configure.argtypes = [ctypes.c_uint, ctypes.c_uint]
                lib.dr_smem_configure.restype = _I
                lib.dr_smem_fault.argtypes = [ctypes.c_char_p, _I]
                lib.dr_smem_fault.restype = _I
            _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            ndim: int, device: torch.device | None = None) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``ndim``
    dimensions (on ``device`` when given)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def route(t: torch.Tensor) -> bool:
    """True to launch the kernel (CUDA tensor), False for the plain version
    (CPU tensor); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")
