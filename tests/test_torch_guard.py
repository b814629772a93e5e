"""The guard-page check of the port's kernels (``deltarice_tpu_torch/
testing/guard.py``, ``chip_smoke.py`` phase 15) on the CPU: the placement
arithmetic against hand-worked cases, the parent's reading of a child's
output, the case list's coverage of every kernel wrapper, every case's
output against its reference (on the CPU the wrappers take their
plain versions; native C and the plain model of B2's tiled passes are the
independent references), and the ragged shapes of case c through the
port's codec against the JAX package.

Every comparison is exact (tolerance 0: the codec is integer and
lossless). The card side is ``tests/test_torch_cuda.py -k guard`` and
``chip_smoke.py`` phase 15.
"""

import functools
import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest

import deltarice_tpu as drt
import deltarice_tpu_torch as dt
from deltarice_tpu.config import RiceConfig as JaxConfig
from deltarice_tpu_torch.models import get_profile
from deltarice_tpu_torch.native import native_compress
from deltarice_tpu_torch.testing import guard

ROOT = Path(__file__).resolve().parents[1]
MiB, KiB = 1 << 20, 1 << 10
# the kernel wrappers, each counted in ops/_kernels.launches where it
# launches its kernel
WRAPPERS = ("pack_encode", "unpack_tables", "unpack_decode",
            "concentrate_packed", "concentrate_wide", "concentrate_wide16",
            "concentrate_tiled", "concentrate_tiled_vd", "split_decode",
            "split_decode_passes", "transpose2d", "iir_decode",
            "iir_decode_serial")


@functools.lru_cache(maxsize=1)
def smoke():
    """``chip_smoke.py``, imported by path (it is a script, not a module of
    a package)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("chip_smoke", mod)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=1)
def cases():
    """Every phase 15 case at small geometries: the published M of each
    profile, segments of 700 (Nab) and 1024 (nEDM, NOPTREX) samples, a
    few rows each."""
    cs = smoke()
    geoms = {
        "nab": (dt.RiceConfig(8, 700),
                get_profile("nab").synthetic(4, seed=0, length=700)),
        "nedm": (dt.RiceConfig(16, 1024),
                 get_profile("nedm").synthetic(2, seed=0, length=1024)),
        "noptrex": (dt.RiceConfig(8, 1024),
                    get_profile("noptrex").synthetic(2, seed=0,
                                                     length=1024)),
    }
    return cs.guard_cases(cs.hostile_cases(), cs.tests_module("tiled_cases"),
                          geoms)


@pytest.mark.parametrize("size,mode,gran,want", [
    # end: the size rounded up to 16 ends at the mapping's last byte
    (1, "end", 2 * MiB, (4 * MiB, 0, 2 * MiB, 2 * MiB - 16, 15)),
    (16, "end", 2 * MiB, (4 * MiB, 0, 2 * MiB, 2 * MiB - 16, 0)),
    (17, "end", 2 * MiB, (4 * MiB, 0, 2 * MiB, 2 * MiB - 32, 15)),
    (4096, "end", 2 * MiB, (4 * MiB, 0, 2 * MiB, 2 * MiB - 4096, 0)),
    (2 * MiB, "end", 2 * MiB, (4 * MiB, 0, 2 * MiB, 0, 0)),
    (2 * MiB + 1, "end", 2 * MiB, (6 * MiB, 0, 4 * MiB, 2 * MiB - 16, 15)),
    (100, "end", 64 * KiB, (128 * KiB, 0, 64 * KiB, 64 * KiB - 112, 12)),
    (3 * 64 * KiB + 5, "end", 64 * KiB,
     (5 * 64 * KiB, 0, 4 * 64 * KiB, 64 * KiB - 16, 11)),
    # front: the buffer starts at the mapping's first byte, one granule in
    (1, "front", 2 * MiB, (4 * MiB, 2 * MiB, 2 * MiB, 2 * MiB, 0)),
    (2 * MiB + 1, "front", 2 * MiB, (6 * MiB, 2 * MiB, 4 * MiB, 2 * MiB, 0)),
    (100, "front", 64 * KiB, (128 * KiB, 64 * KiB, 64 * KiB, 64 * KiB, 0)),
    # size 0: the middle of a granule that is wholly unmapped
    (0, "end", 2 * MiB, (2 * MiB, 0, 0, MiB, 0)),
    (0, "front", 64 * KiB, (64 * KiB, 0, 0, 32 * KiB, 0)),
])
def test_placement_hand_worked(size, mode, gran, want):
    assert guard.placement(size, mode, gran) == guard.Placement(*want)


@pytest.mark.parametrize("gran", [2 * MiB, 64 * KiB])
@pytest.mark.parametrize("mode", guard.MODES)
def test_placement_keeps_a_guard_granule_beside_every_buffer(mode, gran):
    sizes = [1, 2, 15, 16, 17, 31, 33, 4095, 4097, gran - 17, gran - 16,
             gran - 1, gran, gran + 1, 5 * gran + 7]
    sizes += list(np.random.default_rng(0).integers(1, 20 * gran, 50))
    for size in map(int, sizes):
        p = guard.placement(size, mode, gran)
        padded = -(-size // 16) * 16
        assert p.offset % 16 == 0  # the 16-byte vector paths still run
        assert p.map_offset <= p.offset
        assert p.offset + padded <= p.map_offset + p.mapped
        assert p.mapped % gran == 0 and p.mapped - padded < gran
        assert p.reserve == p.mapped + gran  # one granule never mapped
        if mode == "end":
            assert p.map_offset == 0 and p.reserve - p.mapped == gran
            assert p.offset + size + p.slack == p.mapped and p.slack < 16
        else:
            assert p.map_offset == gran == p.offset and p.slack == 0


def test_placement_refuses_an_unknown_mode():
    with pytest.raises(ValueError):
        guard.placement(16, "middle")


_DEAD = """[guard] end placement, poison 0xA5: 3 cases built in 1.0 s
[guard] case a.nab
[guard] ok a.nab 0123456789ab 1.000 s 98 allocations
[guard] case b.nab.one_segment.B2.d1
Traceback (most recent call last):
  File "chip_smoke.py", line 1, in <module>
torch.AcceleratorError: CUDA error: an illegal memory access was encountered
Search for `cudaErrorIllegalAddress' in https://docs.nvidia.com for more.
"""


def test_read_child_names_the_unfinished_case_and_its_error():
    unfinished, error = guard.read_child(_DEAD)
    assert unfinished == "b.nab.one_segment.B2.d1"
    assert error == "CUDA error: an illegal memory access was encountered"
    assert guard.illegal_address(error)


def test_read_child_of_a_finished_run_and_of_a_failed_comparison():
    done = "\n".join(_DEAD.splitlines()[:3])
    assert guard.read_child(done) == (None, None)
    failed = done + ("\n[guard] case c.x\n[guard] FAILED c.x: the output "
                     "differs from the plain version's\n")
    unfinished, error = guard.read_child(failed)
    assert unfinished == "c.x" and error.startswith("[guard] FAILED c.x")
    assert not guard.illegal_address(error)
    abort = done + ("\n[guard] case d.nab\n[guard] cuMemCreate failed: "
                    "CUresult 2 (CUDA_ERROR_OUT_OF_MEMORY)\n")
    assert guard.read_child(abort) == (
        "d.nab", "[guard] cuMemCreate failed: CUresult 2 "
        "(CUDA_ERROR_OUT_OF_MEMORY)")


def test_the_parent_names_a_dead_childs_case_and_error():
    cs = smoke()
    with pytest.raises(cs.SmokeFailure) as e:
        cs.guard_verdict("end", 1, _DEAD)
    assert "b.nab.one_segment.B2.d1" in str(e.value)
    assert "illegal memory access" in str(e.value)
    assert cs.guard_verdict("end", 0, _DEAD) == {"a.nab": "0123456789ab"}
    ctl = ("[guard] case control.end_last\n[guard] ok control.end_last\n"
           "[guard] case control.front_first\n[guard] ok control.front_first"
           "\n[guard] case control.past_end\n[guard] AcceleratorError: CUDA "
           "error: an illegal memory access was encountered\n")
    assert "illegal memory access" in cs.control_verdict("past_end", 1, ctl)
    for fault, rc, out in (("before_start", 1, ctl), ("past_end", 0, ctl),
                           ("past_end", 1, ctl.replace("illegal memory "
                                                       "access", "launch "
                                                       "failure"))):
        with pytest.raises(cs.SmokeFailure):
            cs.control_verdict(fault, rc, out)


def test_the_case_list_covers_every_kernel_wrapper():
    cs = smoke()
    assert sorted(cs.GUARD_KERNELS) == sorted(WRAPPERS) and len(WRAPPERS) == 13
    launched = set().union(*(c.launches for c in cases()))
    assert set(WRAPPERS) | set(cs.IIR_PATHS) <= launched
    names = [c.name for c in cases()]
    assert len(names) == len(set(names))
    assert all(re.fullmatch(r"[abcd]\.\S+", n) for n in names)
    for group in "abcd":
        assert any(n.startswith(f"{group}.") for n in names)


def test_every_counted_launch_is_a_guarded_wrapper():
    """Each name any wrapper counts in ``_kernels.launches`` is in the
    guard's list (a new kernel cannot be left out), and each wrapper the
    guard clones inputs for is defined in the module it names."""
    cs = smoke()
    counted = set()
    for src in (ROOT / "deltarice_tpu_torch" / "ops").glob("*.py"):
        counted |= set(re.findall(r'launches\["(\w+)"\]', src.read_text()))
    assert counted == set(WRAPPERS)
    for module, names in cs.GUARD_WRAPPERS.items():
        text = (ROOT / "deltarice_tpu_torch" / "ops" / f"{module}.py"
                ).read_text()
        for name in names:
            assert f"def {name}(" in text and f'launches["{name}"]' in text


@pytest.mark.parametrize("group", [
    "a.", "b.nab.", "b.nedm.", "b.noptrex.", "c.pack_encode",
    "c.unpack_decode", "c.unpack_tables", "c.concentrate_packed",
    "c.concentrate_wide", "c.concentrate_tiled", "c.transpose2d",
    "c.split_decode", "c.iir_decode", "d."])
def test_cases_match_their_references_on_the_cpu(group):
    """Each case of the group run on the CPU: codec cases against native C,
    B2 on hostile planes against native ``dr_decompress`` and the plain
    model of its tiled passes, B9 + B6 against B2, the generic inverse
    against its plain version. A mismatch raises SmokeFailure."""
    chosen = [c for c in cases() if c.name.startswith(group)]
    assert chosen
    for case in chosen:
        case.run("cpu")


@pytest.mark.parametrize("m", [1, 32768])  # k = 0 and k = 15
@pytest.mark.parametrize("n", [1, 7, 9, 1025, 4099, 7001])
def test_ragged_shapes_match_jax(n, m):
    """Case c's lengths (one sample past B1's 1024-sample tile, ...) through
    the port's CPU codec: byte-identical to the JAX package's stream and
    native C's, and both decodes give the samples back."""
    cs = smoke()
    assert n in cs.RAGGED_N
    x = cs._signal(3, n, n, 15 if m > 1 else 0)
    cfg, jcfg = dt.RiceConfig(m, n), JaxConfig(m, n)
    blob = dt.compress(x, cfg, device="cpu")
    assert blob == bytes(drt.compress(x, jcfg))
    assert blob == native_compress(x, cfg.to_cd_values())
    np.testing.assert_array_equal(dt.decompress(blob, cfg, device="cpu"),
                                  x.ravel())
    np.testing.assert_array_equal(
        np.asarray(drt.decompress(blob, jcfg)).ravel(), x.ravel())


def test_guard_module_imports_neither_jax_nor_the_jax_package():
    import subprocess

    code = ("import sys; import deltarice_tpu_torch.testing.guard; "
            "print(any(m == 'jax' or m.startswith(('jax.', 'deltarice_tpu.'))"
            " or m == 'deltarice_tpu' for m in sys.modules))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "False", res.stderr
