"""B4, the transpose: the port's ``transpose2d`` (on the CPU, its plain
version) and the plain model of the kernel's index map
(``ops/transpose_model.py``: tile walk, register turn, swizzled shared
tile, per-piece masks, the element-wise edge path) against the JAX
package's ``transpose2d`` in interpret mode, 2-D and under ``jax.vmap``.

Inputs come from seeded numpy generators; every comparison is exact. The
model's counts must show what the kernel's design promises: each quarter
warp's 16-byte shared access meets 32 distinct banks, and each warp's
16-byte global access fills whole sectors where the row pitch is a
multiple of 32 bytes (whole 128-byte lines at the JAX package's shapes).
The kernel is held against its plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deltarice_tpu.ops.transpose_pallas import transpose2d as jax_transpose2d
from deltarice_tpu_torch.ops import transpose_model as tm
from deltarice_tpu_torch.ops.transpose_cuda import (
    transpose2d,
    transpose2d_plain,
)

KERNEL = (Path(tm.__file__).resolve().parents[1] / "csrc" / "transpose.cu")
INFO = {np.int16: np.iinfo(np.int16), np.int32: np.iinfo(np.int32)}


def _data(shape, dtype, seed=0):
    info = INFO[dtype]
    rng = np.random.default_rng(seed)
    return rng.integers(info.min, info.max, shape, endpoint=True).astype(dtype)


def _jax(x):
    """JAX's transpose2d in interpret mode; vmapped over a 3-D input."""
    fn = functools.partial(jax_transpose2d, interpret=True)
    if x.ndim == 3:
        fn = jax.vmap(fn)
    return np.asarray(fn(jnp.asarray(x)))


@pytest.mark.parametrize("dtype,shape", [
    (np.int16, (37, 129)), (np.int16, (1, 1)), (np.int16, (300, 7)),
    (np.int16, (64, 520)), (np.int32, (130, 260)), (np.int32, (5, 1024)),
    (np.int32, (33, 65)),
], ids=str)
def test_plain_matches_jax_2d(dtype, shape):
    x = _data(shape, dtype)
    got = transpose2d(torch.from_numpy(x))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), _jax(x))


@pytest.mark.parametrize("dtype,shape", [
    (np.int16, (2, 256, 520)), (np.int32, (3, 130, 1024)),
], ids=str)
def test_plain_matches_jax_vmap(dtype, shape):
    x = _data(shape, dtype, seed=1)
    got = transpose2d(torch.from_numpy(x))
    assert got.shape == (shape[0], shape[2], shape[1]) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), _jax(x))


def test_uint32_goes_through_int32_bits():
    x = _data((3, 40, 72), np.int32, seed=2)
    got = transpose2d(torch.from_numpy(x).view(torch.uint32))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.view(torch.int32).numpy(), _jax(x))


def test_wrapper_takes_two_or_three_axes():
    for shape in [(4,), (2, 2, 2, 2)]:
        with pytest.raises(ValueError):
            transpose2d(torch.zeros(shape, dtype=torch.int16))
    with pytest.raises(TypeError):
        transpose2d(torch.zeros((2, 2), dtype=torch.float32))


# every alignment class of the row pitches: B % P (and A % P) for each
# element size, plus a pointer off its 16-byte boundary
_CLASSES = ([(np.int16, (2, 72, 128 + r), 0) for r in range(8)]
            + [(np.int16, (72 + r, 136), 0) for r in range(1, 8)]
            + [(np.int32, (2, 40, 96 + r), 0) for r in range(4)]
            + [(np.int32, (40 + r, 96), 0) for r in range(1, 4)]
            + [(np.int16, (2, 72, 128), off) for off in (2, 4, 8, 14)]
            + [(np.int32, (40, 96), off) for off in (4, 8, 12)])


@pytest.mark.parametrize("dtype,shape,offset", _CLASSES, ids=str)
def test_model_matches_transpose_every_alignment(dtype, shape, offset):
    x = torch.from_numpy(_data(shape, dtype, seed=3))
    got, path = tm.transpose_model(x, offset)
    p = tm.piece(x.element_size())
    assert path == ("vector" if shape[-1] % p == 0 and shape[-2] % p == 0
                    and offset == 0 else "edge")
    assert torch.equal(got, transpose2d_plain(x))


@pytest.mark.parametrize("dtype,shape", [
    (np.int16, (2, 136, 520)), (np.int16, (3, 64, 7)), (np.int32, (2, 72, 132)),
    (np.int32, (1, 1)), (np.int16, (3, 70)), (np.int16, (70, 3)),
], ids=str)
def test_model_matches_jax(dtype, shape):
    x = _data(shape, dtype, seed=4)
    got, _ = tm.transpose_model(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), _jax(x))


def test_model_uint32():
    x = torch.from_numpy(_data((2, 40, 64), np.int32, seed=5))
    got, path = tm.transpose_model(x.view(torch.uint32))
    assert path == "vector" and got.dtype == torch.uint32
    assert torch.equal(got.view(torch.int32), transpose2d_plain(x))


def test_register_turn_is_a_transpose_of_the_block():
    """The int16 turn (32 byte permutes) and the 32-bit one (a renaming)
    take P pieces of P rows to P pieces of P columns."""
    for esize, dtype in ((2, np.int16), (4, np.int32)):
        p = tm.piece(esize)
        block = torch.from_numpy(_data((5, p, p), dtype, seed=6)).to(
            torch.int64)
        turned = tm.unpack(tm.turn(tm.pack(block, esize), esize), esize)
        assert torch.equal(turned, block.transpose(-2, -1))


@pytest.mark.parametrize("esize", [2, 4])
def test_shared_tile_has_no_bank_conflicts(esize):
    phases = tm.shared_phases(esize)  # (instructions, quarter, 32 banks)
    p = tm.piece(esize)
    assert phases.shape[0] == (tm.BLOCK // 32) * 2 * p
    distinct = torch.sort(phases, dim=-1).values
    assert torch.equal(distinct, torch.arange(32).expand_as(distinct))


def test_edge_tile_has_no_bank_conflicts():
    banks = torch.sort(tm.edge_banks(), dim=-1).values
    assert torch.equal(banks, torch.arange(32).expand_as(banks))


@pytest.mark.parametrize("shape,esize", [
    ((2, 128, 896), 2),  # the JAX encode's (blocks, 1024, lp), cut
    ((2, 896, 128), 2),  # its untile (blocks, rows, 1024), cut
    ((2, 128, 160), 4),  # the JAX decode's word plane, cut
    ((256, 7000 // 8 * 8), 2),
])
def test_jax_shapes_move_whole_lines(shape, esize):
    """Row pitches of whole lines: every load and store instruction covers
    four whole 128-byte lines."""
    req = tm.global_requests(*((1,) + shape)[-3:], esize)
    for side in ("loads", "stores"):
        r = req[side]
        if side == "loads" and shape[-1] * esize % 128:
            assert r["partial_sectors"] > 0  # 7000 samples: 14000 bytes
            continue
        assert r["partial_sectors"] == 0 and r["partial_lines"] == 0
        assert r["lines"] == 4 * r["instructions"]


@pytest.mark.parametrize("a,b,esize", [
    (96, 80, 2), (48, 528, 2), (1040, 16, 2), (24, 40, 4), (8, 1000, 4),
])
def test_stores_fill_whole_sectors(a, b, esize):
    """Where a row pitch is a multiple of 32 bytes, each 16-byte access of
    that side fills whole sectors, the ragged tile edges included."""
    req = tm.global_requests(2, a, b, esize)
    assert a * esize % 32 == 0 and b * esize % 32 == 0
    for side in ("loads", "stores"):
        assert req[side]["partial_sectors"] == 0
    moved = 2 * a * b * esize  # both matrices, each byte once
    assert req["stores"]["sectors"] * 32 == moved
    assert req["loads"]["sectors"] * 32 == moved


@pytest.mark.parametrize("name,value", [
    ("kBlock", tm.BLOCK), ("kWarpsA", tm.WARPS_A), ("kLanesA", tm.LANES_A),
    ("kLanesB", tm.LANES_B), ("kEdgeTile", tm.EDGE_TILE),
    ("kEdgeRows", tm.EDGE_ROWS),
])
def test_model_constants_are_the_kernels(name, value):
    """The model's tile constants as ``csrc/transpose.cu`` defines them."""
    found = re.findall(rf"constexpr int {name} = (\d+);", KERNEL.read_text())
    assert found == [str(value)]
