"""Shared-memory checks of the port's kernels on a card where
``compute-sanitizer`` (racecheck included) does not run: every shared
array held to its extent, shared memory poisoned at kernel entry, and the
warp schedule perturbed.

``csrc/smem_check.h`` declares, reaches and synchronises every shared array
and carve-out of dynamic shared memory of ``csrc/*.cu`` through macros that
expand to the plain code in the default build. The checked build
(``ops/_kernels.py``, :data:`~deltarice_tpu_torch.ops._kernels.
CHECKED_FLAGS`) compiles the same sources with ``-DDR_SMEM_CHECK=1
-lineinfo`` into a library of its own name, where each access checks its
index against its array, each kernel fills its shared memory with a fill
byte at entry (then one barrier), and, where the seed is nonzero, each
access and each barrier or ``cp.async`` wait first sleeps
``__nanosleep(perturb_hash(seed, line, block, thread) & SLEEP_MASK)``.

:func:`install` selects the checked build for a child process before its
first launch and sets its seed and fill byte. ``chip_smoke.py --smem-check
SEED --fill N`` runs phase 15's cases in such a child, with phase 15's
protocol (``[guard] case`` / ``[guard] ok`` lines); a bounds failure stops
the kernel, and the child prints the record the kernel left in mapped host
memory as a ``[smem] fault`` line (file:line, array, index, extent, block,
thread), which :func:`read_child` reads. What this cannot see: ordering
between blocks through global atomics, a race whose window no sleep of
up to ``SLEEP_MASK`` ns opens, and lanes of one warp (a warp's lanes wake
from ``__nanosleep`` together, so a converged warp's hand-off without its
``__syncwarp`` shows only where the lanes already diverge).

``python -m deltarice_tpu_torch.testing.smem control [--fill N]
[--fault]`` runs the positive controls (``smem_control.cu``): a clean
kernel, a read of slots no thread wrote (the fill byte comes back), and
with ``--fault`` a write one past a shared array, which must die naming
its site. ``... mutants`` breaks kernels on purpose in copies of the
checkout (:data:`MUTANTS`) and runs a checked child on each. ``... sass
--baseline DIR`` compares ``cuobjdump -sass`` of the default build with
that of the ``csrc`` in DIR, function by function.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import NamedTuple

from . import guard

SOURCE = Path(__file__).resolve().with_name("smem_control.cu")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
SLEEP_MASK = 0x7FF  # csrc/smem_check.h's kSleepMask
FAULT = "[smem] fault "
UNWRITTEN = "[smem] unwritten "
# (seed, fill) of phase 17's children: no perturbation under two fills,
# then two perturbed schedules
RUNS = ((0, 0xA5), (0, 0x5A), (1, 0xA5), (2, 0x5A))
_M32 = 0xFFFFFFFF
_SITE = re.compile(r"(\S+):(\d+) (\S+) index (-?\d+) extent (-?\d+)")
# an anonymous namespace's name carries two hashes of its translation unit
# (its path among them): dropped, so two trees' functions compare by name
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_(\d+_\w+?)_[0-9a-f]{8}")


def mix32(h: int) -> int:
    h &= _M32
    h ^= h >> 16
    h = (h * 0x7FEB352D) & _M32
    h ^= h >> 15
    h = (h * 0x846CA68B) & _M32
    return h ^ (h >> 16)


def perturb_hash(seed: int, site: int, block=(0, 0, 0),
                 thread=(0, 0, 0)) -> int:
    """The plain model of ``smem_check.h``'s ``perturb_hash``: the sleep
    before an access at line ``site`` is this ``& SLEEP_MASK`` ns."""
    (bx, by, bz), (tx, ty, tz) = block, thread
    h = mix32(seed ^ 0x9E3779B9)
    h = mix32(h ^ site)
    h = mix32(h ^ bx)
    h = mix32(h ^ (((by << 16) & _M32) ^ bz))
    h = mix32(h ^ tx)
    return mix32(h ^ (((ty << 16) & _M32) ^ tz))


def checked_units() -> list[str]:
    """The kernel sources that include ``smem_check.h``: the translation
    units ``dr_smem_configure`` must set."""
    return sorted(p.name for p in CSRC.glob("*.cu")
                  if '#include "smem_check.h"' in p.read_text())


def install(seed: int, fill: int) -> None:
    """Make this process's kernels the checked build with this seed and
    fill byte: before its first launch, once per process."""
    import torch

    from ..ops import _kernels

    if not (0 <= seed < 2 ** 32 and 0 <= fill <= 255):
        raise ValueError(f"seed in 0..2^32-1 and fill in 0..255, got {seed}, "
                         f"{fill}")
    _kernels.use_checked()
    torch.cuda.init()
    n = _kernels.library().dr_smem_configure(seed, fill)
    want = len(checked_units())
    if n != want:
        raise RuntimeError(f"dr_smem_configure set {n} translation units, "
                           f"not the {want} that include smem_check.h")


def fault_text(lib) -> str | None:
    """The first bounds failure a checked library recorded, as text, or
    None. Reads host memory only: it works after the fault killed the
    context."""
    buf = ctypes.create_string_buffer(256)
    return buf.value.decode() if lib.dr_smem_fault(buf, len(buf)) else None


def read_child(text: str) -> tuple[str | None, str | None, str | None]:
    """(the case a child started and did not finish, its first error line,
    the site of the bounds failure it printed) from its output; None where
    there is none."""
    unfinished, error = guard.read_child(text)
    site = next((ln.strip()[len(FAULT):] for ln in text.splitlines()
                 if ln.strip().startswith(FAULT)), None)
    return unfinished, error, site


def parse_site(site: str | None) -> tuple | None:
    """(file, line, array, index, extent) of a ``[smem] fault`` record."""
    m = _SITE.match(site or "")
    if m is None:
        return None
    f, line, array, index, extent = m.groups()
    return f, int(line), array, int(index), int(extent)


def marked_line(path: Path, mark: str) -> int:
    """The line number of the one line of ``path`` that holds ``mark``."""
    hits = [i for i, ln in enumerate(path.read_text().splitlines(), 1)
            if mark in ln]
    if len(hits) != 1:
        raise ValueError(f"{mark!r} is on {len(hits)} lines of {path.name}")
    return hits[0]


# --- the positive controls --------------------------------------------------

def control_library_path() -> Path:
    from ..ops._kernels import BUILD, CHECKED_FLAGS, NVCC_FLAGS

    h = hashlib.sha256(" ".join(NVCC_FLAGS + CHECKED_FLAGS).encode())
    for p in (SOURCE, CSRC / "smem_check.h"):
        h.update(p.read_bytes())
    return BUILD / f"libdr_smem_control_{h.hexdigest()[:16]}.so"


def build_control() -> Path:
    """Compile ``smem_control.cu`` as a checked build (idempotent; an
    atomic replace)."""
    from ..ops._kernels import CHECKED_FLAGS, NVCC_FLAGS, _nvcc

    lib = control_library_path()
    if lib.is_file():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        out = os.path.join(tmp, "lib.so")
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, *CHECKED_FLAGS,
                              f"-I{CSRC}", "-shared", "-o", out, str(SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE.name} (rc="
                               f"{res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(out, lib)
    return lib


def _control_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_control()))
    lib.dr_smem_configure.argtypes = [ctypes.c_uint, ctypes.c_uint]
    lib.dr_smem_configure.restype = ctypes.c_int
    lib.dr_smem_fault.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.dr_smem_fault.restype = ctypes.c_int
    for name in ("smem_control_clean", "smem_control_unwritten",
                 "smem_control_past_end"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def past_end_site() -> tuple:
    """Where the past-end control must die: (file, line, array, index,
    extent)."""
    return (SOURCE.name, marked_line(SOURCE, "// the fault"), "slots", 32, 32)


def control(fill: int, fault: bool) -> int:
    """The positive controls under a perturbed schedule (seed 1) and fill
    byte ``fill``; returns 0, or (``fault``) dies in case
    ``control.past_end`` after printing the bounds record."""
    import torch

    lib = _control_library()
    n = lib.dr_smem_configure(1, fill)
    if n != 1:
        print(f"[guard] FAILED dr_smem_configure set {n} units, not 1",
              flush=True)
        return 1
    stream = torch.cuda.current_stream().cuda_stream
    t = torch.arange(64)
    o = 63 - t
    for name, fn, want in (
            ("control.clean", lib.smem_control_clean, 13 * o + 2 * (o & ~3)),
            ("control.unwritten", lib.smem_control_unwritten,
             torch.where(t < 32, t, fill * 0x01010101))):
        print(f"{guard.CASE}{name}", flush=True)
        out = torch.zeros(64, dtype=torch.int32, device="cuda")
        rc = fn(out.data_ptr(), stream)
        torch.cuda.synchronize()
        got = out.cpu().to(torch.int64) & 0xFFFFFFFF
        if rc != 0 or not torch.equal(got, want):
            print(f"[guard] FAILED {name}: rc {rc}, got {got.tolist()}, "
                  f"want {want.tolist()}", flush=True)
            return 1
        if name == "control.unwritten":
            print(f"{UNWRITTEN}{int(got[32]):#010x} x{int((t >= 32).sum())}",
                  flush=True)
        print(f"{guard.OK}{name}", flush=True)
    if not fault:
        return 0
    print(f"{guard.CASE}control.past_end", flush=True)
    out = torch.zeros(32, dtype=torch.int32, device="cuda")
    try:
        lib.smem_control_past_end(out.data_ptr(), stream)
        torch.cuda.synchronize()  # must raise: thread 32 writes slots[32]
    except RuntimeError:
        print(f"{FAULT}{fault_text(lib)}", flush=True)
        raise
    print(f"[guard] FAILED control.past_end: the write one past the array "
          f"was not stopped", flush=True)
    return 1


def control_verdict(fault: bool, rc: int, out: str) -> str:
    """What a control child must show: the clean and unwritten cases, the
    fill's pattern read back, and (``fault``) death in
    ``control.past_end`` at :func:`past_end_site`. Returns the child's
    unwritten line; raises ``ValueError`` otherwise."""
    unfinished, error, site = read_child(out)
    said = [ln[len(UNWRITTEN):].strip() for ln in out.splitlines()
            if ln.startswith(UNWRITTEN)]
    ok = (f"{guard.OK}control.clean" in out and
          f"{guard.OK}control.unwritten" in out and len(said) == 1)
    if fault:
        ok = (ok and rc not in (0, None) and unfinished == "control.past_end"
              and parse_site(site) == past_end_site())
    else:
        ok = ok and rc == 0 and unfinished is None
    if not ok:
        raise ValueError(f"smem control (fault {fault}): rc {rc}, died in "
                         f"{unfinished} with {error} at {site}:\n"
                         + "\n".join(out.splitlines()[-20:]))
    return said[0]


# --- deliberate faults --------------------------------------------------------

class Mutant(NamedTuple):
    """A deliberate fault in a copy of the checkout: ``text`` of
    ``csrc/<source>`` becomes ``broken``; a checked child with ``seed`` and
    ``fill`` runs the cases whose names start with one of ``cases`` and
    must fail as ``want`` says: ``differs`` (an output differs from its
    reference) or ``bounds FILE ARRAY`` (a bounds record at FILE's array)."""

    name: str
    source: str
    text: str
    broken: str
    seed: int
    fill: int
    cases: tuple
    want: str


MUTANTS = (
    Mutant("B1 emit_kernel leaves sw unzeroed", "pack.cu",
           "  for (int j = threadIdx.x; j < kTileWords; j += kThreads) "
           "DR_SM(sw, j) = 0u;\n", "", 0, 0xA5, ("c.pack_encode",),
           "differs"),
    Mutant("block_scan without its first __syncthreads", "pack.cu",
           "DR_SM(warp_sums, wid) = incl;\n  DR_SYNCTHREADS();\n",
           "DR_SM(warp_sums, wid) = incl;\n", 1, 0xA5,
           ("c.pack_encode", "d."), "differs"),
    Mutant("B9 without the __syncwarp after pass A", "split_decode.cu",
           "DR_SM(ws, 2), rec + b0, 1);\n  DR_SYNCWARP();\n",
           "DR_SM(ws, 2), rec + b0, 1);\n", 2, 0x5A,
           ("c.split_decode", "b.noptrex"), "differs"),
    Mutant("B3 without the __syncwarp after staging", "concentrate.cu",
           "  DR_SYNCWARP();\n", "", 1, 0xA5, ("c.concentrate_packed",),
           "differs"),
    # the two index mutants also give wrong outputs where the index stays
    # inside its array (a short chunk, a tile short of 32 words), which the
    # comparison catches; their cases are ones where it crosses the end
    Mutant("B9 reads s_out one lane run on", "split_decode.cu",
           "DR_SM(so, from * kRunStride + lane)",
           "DR_SM(so, (from + 1) * kRunStride + lane)", 0, 0xA5,
           ("b.noptrex",), "bounds split_decode.cu s_out"),
    Mutant("the walk records one word on", "rice_walk.h",
           "DR_SM(rec, (next >> 5) * stride) =",
           "DR_SM(rec, ((next >> 5) + 1) * stride) =", 0, 0xA5,
           ("c.unpack_tables.n4099", "c.unpack_tables.n7001"),
           "bounds rice_walk.h rec"),
    Mutant("B2's first pass reads the next thread's phase-0 exit",
           "unpack.cu", "DR_SM(exit0, threadIdx.x - 1)",
           "DR_SM(exit0, threadIdx.x + 1)", 0, 0xA5,
           ("c.unpack_decode.n4099",), "bounds unpack.cu exit0"),
    # unperturbed (a sleep before each read would let the copies land), and
    # on full Nab rows, whose tiles go by cp.async (16-byte rows)
    Mutant("the generic inverse without cp_async_wait_one", "prefilter.cu",
           "    cp_async_wait_one();\n", "", 0, 0xA5,
           ("a.nab.1_0_-1", "b.nab.garbage", "c.iir_decode"), "differs"),
)


def mutant_verdict(m: Mutant, rc: int | None, out: str) -> tuple[bool, str]:
    """(caught, what the child showed) for mutant ``m``."""
    unfinished, error, site = read_child(out)
    said = (f"exit {rc} in case {unfinished} with {error}"
            + (f" at {site}" if site else ""))
    if rc in (0, None) or unfinished is None:
        return False, said
    if m.want == "differs":
        return error is not None and "differs" in error, said
    _, where, array = m.want.split()
    p = parse_site(site)
    return p is not None and p[0] == where and p[2] == array, said


def mutants(root: Path) -> int:
    """Every mutant of :data:`MUTANTS` in a copy of the checkout at
    ``root`` (in a temporary directory, all at once) under the checked
    build; 0 where each was caught as it must be."""
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, m in enumerate(MUTANTS):
            copy = Path(tmp) / f"mutant{i}"
            shutil.copytree(root, copy, ignore=shutil.ignore_patterns(
                ".git", "build", "__pycache__"))
            f = copy / "deltarice_tpu_torch" / "csrc" / m.source
            body = f.read_text()
            if body.count(m.text) != 1:
                print(f"[smem] FAILED mutant {i}: {m.text!r} is not in "
                      f"{m.source} once", flush=True)
                return 1
            f.write_text(body.replace(m.text, m.broken))
            cases = [a for c in m.cases for a in ("--cases", c)]
            procs.append(subprocess.Popen(
                [sys.executable, str(copy / "chip_smoke.py"), "--smem-check",
                 str(m.seed), "--fill", str(m.fill), *cases], cwd=copy,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        missed = 0
        for m, proc in zip(MUTANTS, procs):
            try:
                out = proc.communicate(timeout=900)[0]
            except subprocess.TimeoutExpired:
                proc.kill()
                out = proc.communicate()[0] + "\n[guard] FAILED timed out"
            caught, said = mutant_verdict(m, proc.returncode, out)
            missed += not caught
            print(f"[smem] mutant {m.name} ({m.source}, seed {m.seed}, fill "
                  f"0x{m.fill:02X}, cases {' '.join(m.cases)}, want "
                  f"{m.want}): {said}: {'caught' if caught else 'MISSED'}",
                  flush=True)
    return 1 if missed else 0


# --- the default build's SASS against another tree's ------------------------

def sass_functions(lib: Path) -> dict | None:
    """``cuobjdump -sass`` of a library, by function: its lines. None where
    the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).is_file():
        return None
    res = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {res.stderr.strip()}")
    funcs, name = {}, None
    for line in res.stdout.splitlines():
        line = _ANON.sub(r"_GLOBAL__N__\1", line)
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return funcs


def sass(baseline: Path) -> int:
    """The default build of this checkout against the same flags over the
    ``*.cu`` of ``baseline``: 0 where every function's SASS is identical."""
    from ..ops import _kernels

    out = _kernels.BUILD / "sass_baseline" / "lib.so"
    old = sass_functions(_kernels.compile_library(
        Path(baseline), _kernels.NVCC_FLAGS, out))
    new = sass_functions(_kernels.build())
    if old is None or new is None:
        print("[smem] SASS: cuobjdump not found, not compared", flush=True)
        return 2
    same = sorted(n for n in new if old.get(n) == new[n])
    differ = sorted(n for n in new if n in old and old[n] != new[n])
    only = sorted(set(new) ^ set(old))
    lines = sum(len(new[n]) for n in same)
    print(f"[smem] SASS of the default build against {baseline}: "
          f"{len(new)} functions, {len(same)} identical ({lines} lines), "
          f"{len(differ)} differ, {len(only)} in one build only", flush=True)
    for n in differ + only:
        print(f"[smem]   {'differs' if n in differ else 'one build only'}: "
              f"{n}", flush=True)
    return 0 if not differ and not only else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m deltarice_tpu_torch.testing."
                                 "smem", description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("control", help="the positive controls on the card")
    c.add_argument("--fill", type=int, default=0xA5)
    c.add_argument("--fault", action="store_true",
                   help="end with a write one past a shared array")
    sub.add_parser("mutants", help="deliberate faults in copies of the "
                   "checkout, each of which the check must catch")
    s = sub.add_parser("sass", help="the default build's SASS against the "
                       "csrc of another tree, function by function")
    s.add_argument("--baseline", type=Path, required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("smem: no CUDA card", file=sys.stderr)
        return 2
    if args.cmd == "mutants":
        return mutants(Path(__file__).resolve().parents[2])
    if args.cmd == "sass":
        return sass(args.baseline)
    try:
        return control(args.fill, args.fault)
    except RuntimeError as e:
        print(f"[smem] {type(e).__name__}: {e}", flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
