"""Guard pages and poison fills for every CUDA allocation of a process: the
check of the port's kernels for global-memory accesses outside their
buffers on a card where ``compute-sanitizer`` does not run.

``guard_alloc.cu`` (beside this file) is an allocator for PyTorch's
``CUDAPluggableAllocator`` built on CUDA's virtual memory management API
(``cuMemAddressReserve``, ``cuMemCreate``, ``cuMemMap``): every allocation
gets an address reservation of its own, mapped only where the buffer
lies, and filled with a poison byte. :func:`placement` holds its
arithmetic:

* ``end``: the byte size rounded up to 16 (so the 16-byte vector paths
  still run) ends at the last mapped byte, and the next granule is
  reserved and never mapped: an access past the buffer faults, beyond
  less than 16 bytes of slack;
* ``front``: the buffer starts at the first mapped byte, and the granule
  before it is never mapped: an access before the buffer faults;
* size 0: an address in the middle of a granule that is wholly unmapped.

A fault is ``cudaErrorIllegalAddress`` and kills the CUDA context, so a
guarded run is a child process of its own (:func:`install` must come
before the process's first CUDA allocation, and the process uses no CUDA
graphs). The child prints ``[guard] case <name>`` before a case and
``[guard] ok <name>`` after the case's ``torch.cuda.synchronize()``;
:func:`read_child` names the case a dead child left unfinished and its
error. What the guard cannot see: shared memory, an access into the slack
under 16 bytes of an ``end`` buffer, and races.

The library builds from this source with ``nvcc`` at first use, into the
port's git-ignored ``build/``. This module imports without a card or
``nvcc``. ``python -m deltarice_tpu_torch.testing.guard control
[--fault past_end|before_start]`` runs the positive control on the card:
the device's VMM attribute, one buffer mapped and unmapped, the placement
held to the library's, the poison read back, and one-byte reads at the last
byte of an ``end`` buffer and the first of a ``front`` buffer; with
``--fault`` it then reads one byte past the ``end`` buffer or one before
the ``front`` buffer and must die with an illegal address. ``python -m
deltarice_tpu_torch.testing.guard mutants`` breaks kernels on purpose in
copies of the checkout (:data:`MUTANTS`) and runs ``chip_smoke.py``'s
guarded child on each: every fault must be caught.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import NamedTuple

SOURCE = Path(__file__).resolve().with_name("guard_alloc.cu")
MODES = ("end", "front")
ALIGN = 16  # an end buffer's byte size rounds up to this
GRANULE = 2 << 20  # the minimum granularity of an H100's mappings
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O2",
         "-Xcompiler", "-fPIC", "-shared"]
CASE, OK = "[guard] case ", "[guard] ok "
# what a CUDA error looks like in a child's output: torch's RuntimeError,
# a CUresult from the allocator, a failed comparison, or a Python error
_ERRORS = re.compile(r"(CUDA error: .*|cudaError\w+.*|\[guard\] .* failed: "
                     r".*|\[guard\] FAILED .*|^\w*Error: .*)")

_P, _LL = ctypes.c_void_p, ctypes.c_longlong
_LL4 = _LL * 4
_LL6 = _LL * 6


class Placement(NamedTuple):
    """Bytes of a buffer's reservation: its size, where the mapping starts
    and how long it is, where the buffer starts, and the mapped bytes
    between the buffer and its guard granule (after the buffer in ``end``,
    before it in ``front``)."""

    reserve: int
    map_offset: int
    mapped: int
    offset: int
    slack: int


def placement(size: int, mode: str, granularity: int = GRANULE) -> Placement:
    """Where a buffer of ``size`` bytes lies in its reservation; the same
    arithmetic as ``guard_alloc.cu``'s ``place``."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    g = granularity
    if size <= 0:
        return Placement(g, 0, 0, g // 2, 0)
    b = -(-size // ALIGN) * ALIGN
    mapped = -(-b // g) * g
    if mode == "end":
        return Placement(mapped + g, 0, mapped, mapped - b, b - size)
    return Placement(g + mapped, g, mapped, g, 0)


def _nvcc() -> str:
    from ..ops import _kernels

    return _kernels._nvcc()


def library_path() -> Path:
    from ..ops._kernels import BUILD

    h = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes())
    return BUILD / f"libdr_guard_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``guard_alloc.cu`` into the port's build directory
    (idempotent; an atomic replace, so a concurrent process never loads a
    partial file)."""
    lib = library_path()
    if lib.is_file():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    stubs = Path(nvcc).resolve().parents[1] / "lib64" / "stubs"
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        out = os.path.join(tmp, "lib.so")
        res = subprocess.run(
            [nvcc, *FLAGS, "-o", out, str(SOURCE),
             *([f"-L{stubs}"] if stubs.is_dir() else []), "-lcuda"],
            capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE.name} (rc="
                               f"{res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(out, lib)
    return lib


_lib: ctypes.CDLL | None = None
_allocator = None  # the installed CUDAPluggableAllocator, kept alive


def library() -> ctypes.CDLL:
    """The allocator's library, built and loaded on first use. Loading it
    touches no CUDA state."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.guard_placement.argtypes = [_LL, ctypes.c_int, _LL, _LL4]
        lib.guard_placement.restype = None
        lib.guard_device.argtypes = [ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int),
                                     ctypes.POINTER(_LL)]
        lib.guard_device.restype = ctypes.c_int
        lib.guard_configure.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.guard_configure.restype = ctypes.c_int
        lib.guard_stats.argtypes = [_LL6]
        lib.guard_stats.restype = None
        lib.guard_touch.argtypes = [_P, _LL, _P, _P]
        lib.guard_touch.restype = ctypes.c_int
        _lib = lib
    return _lib


def device(index: int = 0) -> tuple[bool, int]:
    """(VMM supported, minimum granularity in bytes) of a card, asked of
    CUDA before the process's runtime starts."""
    vmm, gran = ctypes.c_int(0), _LL(0)
    rc = library().guard_device(index, ctypes.byref(vmm), ctypes.byref(gran))
    if rc != 0:
        raise RuntimeError(f"the device query failed: CUresult {rc}")
    return bool(vmm.value), int(gran.value)


def library_placement(size: int, mode: str, granularity: int) -> Placement:
    """:func:`placement` as the library computes it."""
    out = _LL4()
    library().guard_placement(size, MODES.index(mode), granularity, out)
    reserve, map_offset, mapped, offset = (int(v) for v in out)
    end = map_offset + mapped
    slack = (end - offset - size if mode == "end" else offset - map_offset)
    return Placement(reserve, map_offset, mapped, offset,
                     slack if size > 0 else 0)


def configure(mode: str, fill: int) -> None:
    """The placement and poison byte of the allocations that follow."""
    if mode not in MODES or not 0 <= fill <= 255:
        raise ValueError(f"mode in {MODES} and fill in 0..255, got {mode!r}, "
                         f"{fill}")
    library().guard_configure(MODES.index(mode), fill)


def install(mode: str, fill: int) -> None:
    """Make the guard allocator the process's CUDA allocator: before the
    first CUDA allocation (and before anything else initialises CUDA in
    torch), once per process."""
    global _allocator
    import torch

    vmm, _gran = device(0)
    if not vmm:
        raise RuntimeError("the card refuses virtual memory management "
                           "(CU_DEVICE_ATTRIBUTE_VIRTUAL_MEMORY_MANAGEMENT_"
                           "SUPPORTED is 0)")
    configure(mode, fill)
    _allocator = torch.cuda.memory.CUDAPluggableAllocator(
        str(library_path()), "guard_alloc", "guard_free")
    torch.cuda.memory.change_current_allocator(_allocator)


def stats() -> dict:
    """The allocator's counts: live mappings and their bytes, the peaks of
    both, allocations made, frees that met a dead context."""
    out = _LL6()
    library().guard_stats(out)
    keys = ("live", "live_bytes", "peak", "peak_bytes", "allocs",
            "free_errors")
    return dict(zip(keys, (int(v) for v in out)))


def touch(t, offset: int, out) -> None:
    """Queue the positive control: read the byte at ``offset`` from the
    start of the CUDA tensor ``t`` into the uint8 CUDA tensor ``out``."""
    import torch

    rc = library().guard_touch(t.data_ptr(), offset, out.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"guard_touch launch failed: CUDA error {rc}")


def read_child(text: str) -> tuple[str | None, str | None]:
    """(the last case a child started and did not finish, its first error
    line) from the child's output (standard output and error together);
    None where there is none."""
    started, error = [], None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith(CASE):
            started.append(line[len(CASE):].split()[0])
        elif line.startswith(OK):
            name = line[len(OK):].split()[0]
            if started and started[-1] == name:
                started.pop()
        elif error is None:
            m = _ERRORS.search(line)
            if m:
                error = m.group(1).strip()
    return (started[-1] if started else None), error


def illegal_address(error: str | None) -> bool:
    """True where a child's error is cudaErrorIllegalAddress (torch's
    message, or the allocator's CUresult when its next call met the dead
    context first)."""
    return error is not None and any(
        s in error for s in ("illegal memory access",
                             "cudaErrorIllegalAddress",
                             "CUDA_ERROR_ILLEGAL_ADDRESS"))


def control(fault: str | None) -> int:
    """The positive control (see the module docstring); returns 0, or dies
    with an illegal address after ``[guard] case control.<fault>``."""
    import torch

    vmm, gran = device(0)
    print(f"[guard] device 0: VIRTUAL_MEMORY_MANAGEMENT_SUPPORTED {int(vmm)}, "
          f"granularity {gran} bytes", flush=True)
    if not vmm:
        print("[guard] FAILED the card refuses virtual memory management",
              flush=True)
        return 3
    for g in (gran, GRANULE, 64 << 10):
        for size in (0, 1, 15, 16, 17, 4096, g - 16, g - 1, g, g + 1,
                     3 * g + 5):
            for mode in MODES:
                want = placement(size, mode, g)
                got = library_placement(size, mode, g)
                if got != want:
                    print(f"[guard] FAILED placement of {size} bytes ({mode},"
                          f" granularity {g}): library {got}, Python {want}",
                          flush=True)
                    return 1
    install("end", 0xA5)
    n = 4096  # a multiple of 16: an end buffer ends at its last mapped byte
    one = torch.empty(n, dtype=torch.uint8, device="cuda")
    s = stats()
    ok = (s["live"] == 1 and s["live_bytes"] == gran
          and bool((one.cpu() == 0xA5).all()))
    del one
    torch.cuda.synchronize()
    ok = ok and stats()["live"] == 0
    print(f"[guard] one buffer of {n} bytes mapped ({gran} bytes, poison "
          f"0xA5 read back) and unmapped: {'ok' if ok else 'FAILED'}",
          flush=True)
    if not ok:
        return 1
    out = torch.zeros(1, dtype=torch.uint8, device="cuda")
    end = torch.full((n,), 7, dtype=torch.uint8, device="cuda")
    configure("front", 0x5A)
    front = torch.full((n,), 9, dtype=torch.uint8, device="cuda")
    for name, t, offset, want in (("control.end_last", end, n - 1, 7),
                                  ("control.front_first", front, 0, 9)):
        print(f"{CASE}{name}", flush=True)
        touch(t, offset, out)
        torch.cuda.synchronize()
        if int(out.item()) != want:
            print(f"[guard] FAILED {name}: read {int(out.item())}, wrote "
                  f"{want}", flush=True)
            return 1
        print(f"{OK}{name}", flush=True)
    if fault is None:
        return 0
    t, offset = (end, n) if fault == "past_end" else (front, -1)
    print(f"{CASE}control.{fault}", flush=True)
    touch(t, offset, out)
    torch.cuda.synchronize()  # must raise: the byte is in an unmapped granule
    print(f"{OK}control.{fault}", flush=True)
    print(f"[guard] FAILED control.{fault}: the read at offset {offset} "
          f"did not fault", flush=True)
    return 1


# deliberate faults that a guarded run must catch, each in a copy of the
# checkout: (source under csrc/, its text, the broken text, placement, the
# cases to run, what must happen: death by an illegal address, or an output
# that differs from its reference)
MUTANTS = (
    # B2's tail reads one word past its row: past the plane's last row
    ("unpack.cu", "words[s * w + w - 1]", "words[s * w + w]", "end",
     "b.nab", "illegal"),
    # B5 reads each displacement one slot early: before the plane's start
    ("concentrate_wide.cu", "const int32_t dj = d[j];",
     "const int32_t dj = d[j - 1];", "front", "c.concentrate_wide.",
     "illegal"),
    # the same under end: the read before the start lands in the poison
    ("concentrate_wide.cu", "const int32_t dj = d[j];",
     "const int32_t dj = d[j - 1];", "end", "c.concentrate_wide.",
     "differs"),
    # B2's top-level entry states are never zeroed: the walk starts from the
    # poison, whose phase indexes past the tables
    ("unpack.cu", "base + p.ent[p.levels], 0, nseg * sizeof(uint2), st);",
     "base + p.ent[p.levels], 0, 0, st);", "end", "c.unpack_decode.n1025",
     "illegal"),
)
_FILLS = {"end": 0xA5, "front": 0x5A}


def mutants(root: Path) -> int:
    """Run every mutant of :data:`MUTANTS` in a copy of the checkout at
    ``root`` (in a temporary directory, all at once) under the guard
    allocator; 0 where each was caught as it must be."""
    import shutil

    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (src, text, broken, mode, cases, want) in enumerate(MUTANTS):
            copy = Path(tmp) / f"mutant{i}"
            shutil.copytree(root, copy, ignore=shutil.ignore_patterns(
                ".git", "build", "__pycache__"))
            f = copy / "deltarice_tpu_torch" / "csrc" / src
            body = f.read_text()
            if body.count(text) != 1:
                print(f"[guard] FAILED mutant {i}: {text!r} is not in {src} "
                      f"once", flush=True)
                return 1
            f.write_text(body.replace(text, broken))
            procs.append(subprocess.Popen(
                [sys.executable, str(copy / "chip_smoke.py"), "--guard", mode,
                 "--fill", str(_FILLS[mode]), "--cases", cases], cwd=copy,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        missed = 0
        for (src, text, broken, mode, cases, want), proc in zip(MUTANTS,
                                                                procs):
            out = proc.communicate(timeout=900)[0]
            unfinished, error = read_child(out)
            caught = proc.returncode != 0 and unfinished is not None and (
                illegal_address(error) if want == "illegal"
                else error is not None and "differs" in error)
            missed += not caught
            print(f"[guard] mutant {src}: {text!r} -> {broken!r} under "
                  f"{mode}: exit {proc.returncode} in case {unfinished} with "
                  f"{error}: {'caught' if caught else 'MISSED'}", flush=True)
    return 1 if missed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m deltarice_tpu_torch.testing."
                                 "guard", description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("control", help="the positive control on the card")
    c.add_argument("--fault", choices=("past_end", "before_start"))
    sub.add_parser("mutants", help="deliberate faults in copies of the "
                   "checkout, each of which the guard must catch")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("guard: no CUDA card", file=sys.stderr)
        return 2
    if args.cmd == "mutants":
        return mutants(Path(__file__).resolve().parents[2])
    try:
        return control(args.fault)
    except RuntimeError as e:
        print(f"[guard] {type(e).__name__}: {e}", flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
