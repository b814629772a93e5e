"""The plain model of the generic inverse's blocked scan
(``deltarice_tpu_torch/ops/prefilter_model.py``: pass A's exit histories,
pass B's carry along each row by the block transition, pass C's final
walk) against the JAX package's ``_iir_decode`` and the port's plain
inverse, on the CPU.

The grid: six lossless filters (their leading tap +-1 mod 2**16, up to 8
history taps, taps at the int16 edges) x block lengths 8, 96 and 256 x
rows shorter than a block, of one block, of three, of three and one sample
x 1 and 33 rows. Inputs come from numpy seeds (``tests/prefilter_cases.py``);
every comparison is exact (tolerance 0: the inverse is integer arithmetic).
The card's kernel is held against the plain version on the same grid by
``tests/test_torch_cuda.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltarice_tpu.ops import prefilter as jpre
from deltarice_tpu_torch.ops import prefilter, prefilter_model as pm
from prefilter_cases import BLOCKED_FILTERS, blocked_grid, samples

ROWS = 33


@functools.lru_cache(maxsize=None)
def _input(n: int) -> np.ndarray:
    return samples((ROWS, n), n)


@functools.lru_cache(maxsize=None)
def _jax(filt: tuple[int, ...], n: int) -> np.ndarray:
    return np.asarray(jpre._iir_decode(jnp.asarray(_input(n)), filt))


@pytest.mark.parametrize("filt,block,n,rows", blocked_grid(), ids=str)
def test_blocked_model_matches_jax_and_plain(filt, block, n, rows):
    d = torch.from_numpy(_input(n)[:rows])
    got = pm.blocked_decode(d, filt, block)
    assert got.dtype == torch.int16 and got.shape == d.shape
    np.testing.assert_array_equal(got.numpy(), _jax(filt, n)[:rows])
    assert torch.equal(got, prefilter.iir_decode_plain(d, filt))


@pytest.mark.parametrize("filt", BLOCKED_FILTERS, ids=str)
@pytest.mark.parametrize("block", [8, 96, 256, 1000])
def test_block_transition_is_the_companion_power(filt, block):
    """M, walked from the unit histories, equals the companion matrix of
    the folded recurrence raised to the block length by squaring."""
    s, taps = pm.fold(filt)
    t = len(taps)
    if t == 0:
        return
    comp = np.zeros((t, t), dtype=object)
    comp[0] = [-c for c in taps]
    for j in range(1, t):
        comp[j, j - 1] = 1
    power, base, e = np.identity(t, dtype=object), comp, block
    while e:
        if e & 1:
            power = power.dot(base) % 65536
        base, e = base.dot(base) % 65536, e >> 1
    got = pm.block_transition(filt, block)
    assert got.dtype == torch.int64 and got.shape == (t, t)
    np.testing.assert_array_equal(got.numpy(), power.astype(np.int64))


def test_passes_compose_the_exit_histories():
    """Pass A's exit history of every full block, and pass B's entries,
    equal the outputs of the plain inverse at the block boundaries."""
    filt, block = (1, -1, 0, 1), 96
    d = torch.from_numpy(samples((5, 4 * block + 7), 11))
    want = prefilter.iir_decode_plain(d, filt).to(torch.int64) & 0xFFFF
    exits = pm.exit_states(d, filt, block)
    entries = pm.carry_scan(exits, pm.block_transition(filt, block))
    assert exits.shape == entries.shape == (5, 4, 3)
    for b in range(4):
        end = (b + 1) * block
        assert torch.equal(entries[:, b], want[:, end - 3: end].flip(-1))
    # block 0 starts from a zero history, so its exit is already the truth
    assert torch.equal(exits[:, 0] & 0xFFFF, entries[:, 0])


@pytest.mark.parametrize("shape,block", [((2048, 7000), 1024),
                                         ((64, 500000), 2048),
                                         ((32, 500000), 1024),
                                         ((1, 500000), 256),
                                         ((40000, 7000), 8192),
                                         ((3, 200), 256)], ids=str)
def test_block_length_depends_on_the_shape(shape, block):
    rows, n = shape
    assert pm.choose_block(rows, n) == block
    path, got, nb = pm.plan((1, 0, -1), rows, n)
    assert got == block and nb == -(-n // block)
    assert path == ("blocked" if nb > 1 else "one_walk")


@pytest.mark.parametrize("filt,path", [
    ((1, 0, -1), "blocked"), ((65535, 1), "blocked"), ((1,), "one_walk"),
    ((-65537,), "one_walk"), ((8, -1), "serial"), ((65536, -1), "serial"),
    ((2,), "serial"), ((1,) + (0,) * 8 + (1,), "serial"),
    ((1,) + (0,) * 7 + (1,), "blocked")], ids=str)
def test_routing_depends_on_the_filter(filt, path):
    assert pm.plan(filt, 64, 7000)[0] == path
    if path == "serial":
        with pytest.raises(ValueError):
            pm.blocked_decode(torch.zeros((2, 8), dtype=torch.int16), filt)


def test_block_lengths_must_be_multiples_of_8():
    with pytest.raises(ValueError, match="multiple of 8"):
        pm.plan((1, -1, 0, 1), 4, 100, block=12)


@pytest.mark.parametrize("shape", [(0, 9), (4, 0), (2, 3, 50)], ids=str)
def test_blocked_model_odd_shapes(shape):
    filt = (1, -1, 0, 1)
    d = torch.from_numpy(samples(shape, 3))
    got = pm.blocked_decode(d, filt, 16)
    assert got.shape == d.shape and got.dtype == torch.int16
    assert torch.equal(got, prefilter.iir_decode_plain(d, filt))
