"""ctypes loader for the repository's native C codec (``dr_codec.c``).

The port reuses the C sources that ship beside the JAX package
(``deltarice_tpu/native/src/``) by path, without importing that package:
``dr_codec.c`` includes only ``dr_codec.h`` and compiles alone. It is built
on first use with the system C compiler into ``deltarice_tpu_torch/build/``
and gives the codec its host routines (header walk, ragged gather, stream
framing) and an independent whole-chunk codec (``dr_compress`` /
``dr_decompress``) to hold the port against.

Without a C compiler :func:`codec_lib` returns None and the host routines
take their numpy versions.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SRC = _PKG.parent / "deltarice_tpu" / "native" / "src" / "dr_codec.c"
LIB = _PKG / "build" / "native" / "libdr_codec.so"

_P = ctypes.c_void_p
_SZ = ctypes.c_size_t


class DrConfig(ctypes.Structure):
    """``dr_config`` of ``dr_codec.h``."""

    _fields_ = [
        ("m", ctypes.c_uint32),
        ("k", ctypes.c_int),
        ("seg_len", ctypes.c_int64),
        ("filt", ctypes.POINTER(ctypes.c_int32)),
        ("filt_len", ctypes.c_size_t),
    ]


_SIGNATURES = {
    "dr_walk_headers": (ctypes.c_int, [_P, _SZ, _SZ, _P, _P]),
    "dr_gather_rows": (None, [_P, _SZ, _P, _P, _SZ, _P]),
    "dr_frame_rows": (None, [_P, _SZ, _SZ, _P, _P, ctypes.c_uint32, _P]),
    "dr_merge_substreams": (None, [_P, _SZ, _SZ, _SZ, _P, _SZ, _P]),
    "dr_config_parse": (ctypes.c_int, [_SZ, _P, ctypes.POINTER(DrConfig)]),
    "dr_config_free": (None, [ctypes.POINTER(DrConfig)]),
    "dr_compress": (ctypes.c_int, [_P, _SZ, ctypes.POINTER(DrConfig),
                                   ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32)),
                                   ctypes.POINTER(_SZ)]),
    "dr_decompress": (ctypes.c_int, [_P, _SZ, ctypes.POINTER(DrConfig),
                                     ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)),
                                     ctypes.POINTER(_SZ)]),
}


def build() -> Path:
    """Compile ``dr_codec.c`` into :data:`LIB` (atomic replace, so
    a concurrent process never loads a half-written file)."""
    cc = shutil.which("cc") or shutil.which("gcc") or shutil.which("clang")
    if cc is None:
        raise RuntimeError("no C compiler found")
    LIB.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=LIB.parent)
    os.close(fd)
    try:
        res = subprocess.run(
            [cc, "-O3", "-fPIC", "-shared", "-fopenmp", str(SRC), "-o", tmp],
            capture_output=True, text=True,
        )
        if res.returncode != 0:
            raise RuntimeError(f"native build failed:\n{res.stderr}")
        os.replace(tmp, LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return LIB


def _is_built() -> bool:
    return LIB.is_file() and LIB.stat().st_mtime >= max(
        SRC.stat().st_mtime, SRC.with_suffix(".h").stat().st_mtime
    )


_codec_lib: "ctypes.CDLL | None | bool" = False  # False = not yet tried


def codec_lib() -> "ctypes.CDLL | None":
    """The native codec library, built on first use; None where the sources
    or a C compiler are missing. Cached for the process."""
    global _codec_lib
    if _codec_lib is False:
        lib = None
        try:
            if not _is_built():
                build()
            lib = ctypes.CDLL(str(LIB))
        except (OSError, RuntimeError):
            lib = None
        if lib is not None:
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
        _codec_lib = lib
    return _codec_lib


def _require() -> ctypes.CDLL:
    lib = codec_lib()
    if lib is None:
        raise RuntimeError(f"native codec unavailable (could not build {SRC})")
    return lib


def _config(lib: ctypes.CDLL, cd_values) -> DrConfig:
    cd = np.ascontiguousarray(cd_values, dtype=np.uint32)
    cfg = DrConfig()
    if lib.dr_config_parse(cd.size, cd.ctypes.data, ctypes.byref(cfg)) != 0:
        raise ValueError(f"invalid cd_values {tuple(cd_values)}")
    return cfg


_libc = ctypes.CDLL(None)
_libc.free.argtypes = [_P]
_libc.free.restype = None


def native_compress(samples, cd_values) -> bytes:
    """``dr_compress`` of one chunk of int16 samples: the framed stream."""
    lib = _require()
    x = np.ascontiguousarray(samples, dtype=np.int16).ravel()
    cfg = _config(lib, cd_values)
    out = ctypes.POINTER(ctypes.c_uint32)()
    n_out = _SZ()
    try:
        rc = lib.dr_compress(x.ctypes.data, x.size, ctypes.byref(cfg),
                             ctypes.byref(out), ctypes.byref(n_out))
    finally:
        lib.dr_config_free(ctypes.byref(cfg))
    if rc != 0:
        raise RuntimeError("dr_compress failed")
    try:
        return ctypes.string_at(out, 4 * n_out.value)
    finally:
        _libc.free(ctypes.cast(out, _P))


def native_decompress(stream, cd_values) -> np.ndarray:
    """``dr_decompress`` of one framed stream: flat int16 samples."""
    lib = _require()
    buf = np.frombuffer(memoryview(stream), dtype="<u4")
    cfg = _config(lib, cd_values)
    out = ctypes.POINTER(ctypes.c_int16)()
    n_out = _SZ()
    try:
        rc = lib.dr_decompress(buf.ctypes.data, buf.size, ctypes.byref(cfg),
                               ctypes.byref(out), ctypes.byref(n_out))
    finally:
        lib.dr_config_free(ctypes.byref(cfg))
    if rc != 0:
        raise ValueError("dr_decompress rejected the stream")
    try:
        return np.frombuffer(ctypes.string_at(out, 2 * n_out.value),
                             dtype=np.int16).copy()
    finally:
        _libc.free(ctypes.cast(out, _P))
