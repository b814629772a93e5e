"""ctypes loader for the repository's native C codec and HDF5 filter plugin.

The port keeps its own copy of the JAX package's C sources in
``deltarice_tpu_torch/native/src/`` (byte for byte those of
``deltarice_tpu/native/src/``; a test holds them so): ``dr_codec.c`` (the
codec and its host routines) and ``h5z_deltarice.c`` (the HDF5 filter
class for ID 32025 and the dynamic-plugin entry points).
Both build on first use, with the system C compiler, into one shared
library under ``deltarice_tpu_torch/build/native/``. It gives the codec its
host routines (header walk, ragged gather, stream framing), an independent
whole-chunk codec (``dr_compress`` / ``dr_decompress``) to hold the port
against, and the filter plugin that :func:`register_with_h5py` registers
into h5py's HDF5 and :mod:`.install` copies into a plugin directory.

No HDF5 headers are needed: the filter declares the HDF5 ABI it uses and
resolves libhdf5 at run time.

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
SRC_DIR = Path(__file__).resolve().parent / "src"
SOURCES = (SRC_DIR / "dr_codec.c", SRC_DIR / "h5z_deltarice.c")
LIB = _PKG / "build" / "native" / "libh5deltarice_tpu_torch.so"

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
    """Compile :data:`SOURCES` into :data:`LIB` (atomic replace, so a
    concurrent process never loads a half-written file)."""
    cc = shutil.which("cc") or shutil.which("gcc") or shutil.which("clang")
    if cc is None:
        raise RuntimeError("no C compiler found")
    LIB.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=LIB.parent)
    os.close(fd)
    try:
        # -z nodelete: HDF5's plugin loader dlcloses filter plugins at
        # H5close; unmapping the library would also unmap libgomp while its
        # worker threads are parked in it (the JAX package's _build.py)
        res = subprocess.run(
            [cc, "-O3", "-fPIC", "-shared", "-Wall", "-fopenmp",
             *map(str, SOURCES), "-o", tmp, "-ldl", "-Wl,-z,nodelete"],
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
        p.stat().st_mtime for p in (*SOURCES, SRC_DIR / "dr_codec.h"))


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
        raise RuntimeError(f"native codec unavailable (could not build "
                           f"{LIB.name} from {SRC_DIR})")
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


def register_with_h5py() -> bool:
    """Load the filter plugin and register filter 32025 into h5py's HDF5.

    The plugin resolves ``H5Zregister`` from the libhdf5 that h5py loaded
    (:func:`_candidate_hdf5_libs`), so no HDF5 development install is
    needed. Registering again (this package or the JAX package's plugin in
    the same process) replaces the filter class and succeeds. Returns True
    on success, False where h5py, the C compiler or libhdf5 is missing.
    """
    try:
        if not _is_built():
            build()
        import h5py  # loads libhdf5 into the process
    except (ImportError, OSError, RuntimeError):
        return False
    try:
        lib = ctypes.CDLL(str(LIB), mode=ctypes.RTLD_GLOBAL)
        lib.dr_h5_init_from.argtypes = [ctypes.c_char_p]
        lib.dr_h5_init_from.restype = ctypes.c_int
        lib.deltarice_tpu_register.argtypes = []
        lib.deltarice_tpu_register.restype = ctypes.c_int
        for hdf5 in _candidate_hdf5_libs(h5py):
            if lib.dr_h5_init_from(hdf5.encode()) == 0:
                break
        return lib.deltarice_tpu_register() >= 0
    except OSError:
        return False


def _candidate_hdf5_libs(h5py) -> list[str]:
    """Shared libraries that may export the HDF5 API in an h5py install:
    the wheel-bundled libhdf5 (manylinux ``h5py.libs``) or, for
    system-linked builds, h5py's own extension modules (which re-export
    through their DT_NEEDED libhdf5)."""
    import glob

    root = Path(h5py.__file__).resolve().parent
    cands: list[str] = []
    for pat in ("../h5py.libs/libhdf5*.so*", "../h5py.libs/libhdf5*"):
        cands.extend(sorted(glob.glob(str(root / pat))))
    cands.extend(sorted(glob.glob(str(root / "defs*.so"))))
    cands.extend(sorted(glob.glob(str(root / "h5z*.so"))))
    return cands
