"""The plain model of B7's and B8's decomposition
(``ops/concentrate_tiled_model.py``: stages of 128 slots x 32 columns,
store runs of 32 slots at the intermediate's offsets, the swizzled 64 x 64
tiles back)
against the JAX package's ``concentrate_tiled`` / ``concentrate_tiled_vd``
in interpret mode, on the CPU.

The cases are ``tests/tiled_cases.py``'s, made from numpy seeds, each with
the four plane kinds (B8's two planes; B7's packed, sign-biased and packed
with a u32 follower); every comparison is exact. The model's counts must
hold the live slots that land inside the output, in at most as many store
instructions. The kernels are held against their plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deltarice_tpu.ops.concentrate_pallas import (
    concentrate_tiled as jax_tiled,
    concentrate_tiled_vd as jax_tiled_vd,
)
from deltarice_tpu_torch.ops.concentrate_cuda import DEAD
from deltarice_tpu_torch.ops.concentrate_tiled_cuda import (
    out_rows,
    tile,
    untile,
)
from deltarice_tpu_torch.ops.concentrate_tiled_model import (
    concentrate_tiled_model,
    concentrate_tiled_vd_model,
    swizzle,
)
from tiled_cases import CASES, KINDS, lead_plane, planes


def _jax_b7(planes, n_out, sb, bound, emit, bias):
    return np.asarray(jax_tiled(tuple(jnp.asarray(p.numpy()) for p in planes),
                                n_out, sb, bound, emit, True, bias))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_model_matches_jax(case, kind):
    ps, (vals, disp), sb, n_out, _lanes = planes(case, kind)
    bound = max(int(disp.max()), 0)
    rows = out_rows(vals.shape[1] * sb, n_out, sb)
    if kind == "vd":
        got, stats = concentrate_tiled_vd_model(*ps, n_out, sb)
        want = np.asarray(jax_tiled_vd(*(jnp.asarray(p.numpy()) for p in ps),
                                       n_out, sb, bound, True))
        want = want[:, :rows]  # the JAX levels return whole windows
    else:
        emit, bias = ("u32" if kind == "u32" else "int16"), kind == "bias"
        got, stats = concentrate_tiled_model(ps, n_out, sb, emit, bias)
        want = _jax_b7(ps, n_out, sb, bound, emit, bias)
    assert got.shape[1] == rows
    np.testing.assert_array_equal(got.numpy(), want.view(got.numpy().dtype))
    dest = np.arange(vals.shape[1]) - disp
    kept = int(((disp >= 0) & (dest < rows // sb)).sum())
    esize = got.element_size()
    assert stats["kept"] == kept
    assert stats["store_instructions"] <= kept <= 32 * stats[
        "store_instructions"]
    assert stats["store_sectors"] >= -(-kept * esize // 32)
    if case == "all_home":
        # each store instruction one aligned run of 32 slots
        assert stats["store_instructions"] == kept // 32
        assert stats["store_sectors"] == kept * esize // 32


def test_model_bias_dead_collision():
    """A live 0 at displacement 0 is the biased dead marker: the walk skips
    it and the memset gives its value."""
    vals = np.zeros((128, 3000), np.int16)
    disp = np.full((128, 3000), -1, np.int32)
    disp[:, 0] = 0
    vals[:, 5] = 1234
    disp[:, 5] = 4
    lead = tile(torch.from_numpy(lead_plane(vals, disp, True)), 1, DEAD)
    got, stats = concentrate_tiled_model((lead,), 4, 1, bias=True)
    want = _jax_b7((lead,), 4, 1, 2000, "int16", True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats["kept"] == 128
    back = untile(got, 128, 1)
    assert back[:, 0].eq(0).all() and back[:, 1].eq(1234).all()


@pytest.mark.parametrize("esize", [2, 4])
def test_swizzle_permutes_each_row(esize):
    """Pass 2's shared-memory tile keeps each row's elements in distinct
    places, whole 16-byte pieces together."""
    at = swizzle(esize)
    p = 16 // esize
    assert torch.equal(at.sort(-1).values,
                       torch.arange(64).expand(64, 64))
    assert torch.equal(at % p, torch.arange(64).expand(64, 64) % p)
