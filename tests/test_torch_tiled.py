"""B7 and B8 (concentration in the TPU decode staging's tiled layout)
against the JAX package, on the CPU.

The same tiled planes, made from numpy seeds, go through the port's
``concentrate_tiled`` / ``concentrate_tiled_vd`` (their plain versions, as
the tensors lie on the CPU) and through the JAX functions in interpret
mode; every comparison is exact. ``decode_staging`` builds the staging the
JAX decode kernel emits from real encoded streams; it must equal what
``_kernel_program`` (the kernel in interpret mode, with its unroll constant
``_GROUP`` set to 1 — words per loop step, which changes nothing but the
compile time) emits, and both packages must concentrate it back into the
decoded samples. The kernels themselves are
held against the plain versions on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deltarice_tpu.ops import unpack_pallas as jup
from deltarice_tpu.ops.concentrate_pallas import (
    concentrate_tiled as jax_tiled,
    concentrate_tiled_vd as jax_tiled_vd,
)
import deltarice_tpu_torch as dt
from deltarice_tpu_torch import codec
from deltarice_tpu_torch.ops.concentrate_cuda import DEAD
from deltarice_tpu_torch.ops.concentrate_tiled_cuda import (
    concentrate_tiled,
    concentrate_tiled_vd,
    decode_staging,
    out_rows,
    staging_route,
    tile,
    untile,
)


def _case(nseg, r, density, seed, dtype=np.int16):
    """Random monotone conflict-free (values, disp, n_out, dense)."""
    rng = np.random.default_rng(seed)
    valid = rng.random((nseg, r)) < density
    dest = np.cumsum(valid, axis=1) - 1
    disp = np.where(valid, np.arange(r)[None, :] - dest, -1).astype(np.int32)
    info = np.iinfo(dtype)
    vals = rng.integers(info.min, info.max + 1, (nseg, r)).astype(dtype)
    n_out = max(int(valid.sum(axis=1).max()), 1)
    dense = np.zeros((nseg, n_out), dtype=dtype)
    for i in range(nseg):
        dense[i, : valid[i].sum()] = vals[i, valid[i]]
    return vals, disp, n_out, dense


def _lead(halves, disp, bias=False):
    """Packed (or sign-biased) leader plane as int32, dead INT32_MIN."""
    p = (disp.astype(np.int64) << 16) | (halves.astype(np.int64) & 0xFFFF)
    if bias:
        p ^= 1 << 31
    return np.where(disp >= 0, p, DEAD).astype(np.int64).astype(np.int32)


def _tiled(a, sb, fill):
    return tile(torch.from_numpy(np.ascontiguousarray(a)), sb, fill)


def _check_dense(got, nseg, sb, n_out, dense):
    back = untile(got, nseg, sb)[:, :n_out].numpy()
    np.testing.assert_array_equal(back, dense.view(back.dtype))


def test_tile_layout():
    """Row slot*sb + s, lane l holds slot ``slot`` of segment s*128 + l."""
    a = torch.arange(300 * 5, dtype=torch.int32).reshape(300, 5)
    t = tile(a, 4, -1)
    assert t.shape == (1, 20, 128)
    assert int(t[0, 3 * 4 + 2, 7]) == int(a[2 * 128 + 7, 3])
    assert int(t[0, 2, 300 - 256]) == -1  # segment 300: padding
    assert torch.equal(untile(t, 300, 4), a)


@pytest.mark.parametrize("nseg,r,density,sb", [
    (300, 200, 0.5, 8), (300, 1500, 0.3, 8), (100, 9000, 0.8, 1),
])
def test_concentrate_tiled_int16_matches_jax(nseg, r, density, sb):
    vals, disp, n_out, dense = _case(nseg, r, density, r)
    lead = _tiled(_lead(vals, disp), sb, DEAD)
    got = concentrate_tiled((lead,), n_out, sb)
    want = np.asarray(jax_tiled((jnp.asarray(lead.numpy()),), n_out, sb,
                                max(int(disp.max()), 0), "int16", True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape[1] == out_rows(lead.shape[1], n_out, sb)
    _check_dense(got, nseg, sb, n_out, dense)


def test_concentrate_tiled_u32_follower_matches_jax():
    vals, disp, n_out, dense = _case(160, 6000, 0.35, 5, np.uint32)
    lead = _tiled(_lead(vals >> 16, disp), 2, DEAD)
    fol = _tiled((vals & 0xFFFF).astype(np.uint16).view(np.int16), 2, 0)
    got = concentrate_tiled((lead, fol), n_out, 2, "u32")
    want = np.asarray(jax_tiled(
        (jnp.asarray(lead.numpy()), jnp.asarray(fol.numpy())), n_out, 2,
        int(disp.max()), "u32", True))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    _check_dense(got, 160, 2, n_out, dense)


@pytest.mark.parametrize("r,density,emit", [
    (3000, 0.3, "int16"), (60000, 0.3, "int16"), (9000, 0.9, "u32"),
])
def test_concentrate_tiled_bias_matches_jax(r, density, emit):
    """Sign-biased plane: displacements up to 2^16 - 1."""
    vals, disp, n_out, dense = _case(40, r, density, r + 1)
    bound = max(int(disp.max()), 0)
    assert bound < (1 << 16)
    lead = _tiled(_lead(vals, disp, bias=True), 1, DEAD)
    got = concentrate_tiled((lead,), n_out, 1, emit, bias=True)
    want = np.asarray(jax_tiled((jnp.asarray(lead.numpy()),), n_out, 1,
                                bound, emit, True, True))
    np.testing.assert_array_equal(got.numpy(), want.view(got.numpy().dtype))
    if emit == "int16":
        _check_dense(got, 40, 1, n_out, dense)


def test_concentrate_tiled_bias_dead_collision():
    """A live 0 at displacement 0 equals the dead marker and reads 0."""
    vals = np.zeros((128, 3000), np.int16)
    disp = np.full((128, 3000), -1, np.int32)
    disp[:, 0] = 0
    vals[:, 5] = 1234
    disp[:, 5] = 4
    lead = _tiled(_lead(vals, disp, bias=True), 1, DEAD)
    got = concentrate_tiled((lead,), 4, 1, bias=True)
    want = np.asarray(jax_tiled((jnp.asarray(lead.numpy()),), 4, 1, 2000,
                                "int16", True, True))
    np.testing.assert_array_equal(got.numpy(), want)
    back = untile(got, 128, 1)
    assert back[:, 0].eq(0).all() and back[:, 1].eq(1234).all()


def test_concentrate_tiled_n_out_wider_than_slots():
    vals, disp, n_out, dense = _case(100, 300, 0.2, 2)
    lead = _tiled(_lead(vals, disp), 8, DEAD)
    got = concentrate_tiled((lead,), 800, 8)
    want = np.asarray(jax_tiled((jnp.asarray(lead.numpy()),), 800, 8,
                                max(int(disp.max()), 0), "int16", True))
    np.testing.assert_array_equal(got.numpy(), want)
    back = untile(got, 100, 8)
    assert back.shape[1] == 512  # whole blocks covering the 300 slots
    np.testing.assert_array_equal(back[:, :n_out].numpy(), dense)
    assert not back[:, n_out:].any()


def test_concentrate_tiled_rejects_bad_planes():
    lead = torch.zeros((1, 16, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        concentrate_tiled((lead,), 4, 3)  # 16 rows, sb=3
    with pytest.raises(ValueError):
        concentrate_tiled((lead, lead.to(torch.int16)), 4, 1, bias=True)
    with pytest.raises(ValueError):
        concentrate_tiled((lead,), 4, 1, "u16")


@pytest.mark.parametrize("nseg,r,density,sb", [
    (128, 900, 0.9, 1),      # L1 only (disp < 256)
    (256, 6000, 0.4, 2),     # L1 + L2
    (128, 70000, 0.3, 1),    # L1 + L2 + L3 (disp crosses 256 * 128)
    (2048, 300, 0.4, 8),     # two 1024-segment blocks
])
def test_concentrate_tiled_vd_matches_jax(nseg, r, density, sb):
    vals, disp, n_out, dense = _case(nseg, r, density, r + 9)
    v, d = _tiled(vals, sb, 0), _tiled(disp, sb, -1)
    got = concentrate_tiled_vd(v, d, n_out, sb)
    want = np.asarray(jax_tiled_vd(jnp.asarray(v.numpy()),
                                   jnp.asarray(d.numpy()), n_out, sb,
                                   max(int(disp.max()), 0), True))
    rows = got.shape[1]
    assert rows == out_rows(v.shape[1], n_out, sb) and want.shape[1] >= rows
    np.testing.assert_array_equal(got.numpy(), want[:, :rows])
    assert not want[:, rows:].any()  # the JAX levels' whole windows
    _check_dense(got, nseg, sb, n_out, dense)


def test_concentrate_tiled_vd_lone_far_element():
    r = 70000
    vals = np.zeros((128, r), np.int16)
    disp = np.full((128, r), -1, np.int32)
    vals[:, r - 1] = np.arange(128) % 31 + 1
    disp[:, r - 1] = r - 1
    got = untile(concentrate_tiled_vd(_tiled(vals, 1, 0), _tiled(disp, 1, -1),
                                      4, 1), 128, 1)
    np.testing.assert_array_equal(got[:, 0].numpy(), vals[:, r - 1])
    assert not got[:, 1:].any()


def _streams(k, length, nseg, seed):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.normal(0, 3, (nseg, length)).round(),
                  -1).astype(np.int16)
    cfg = dt.RiceConfig(1 << k, length)
    buf = np.frombuffer(dt.compress(x, cfg, device="cpu"), dtype="<u4")
    counts, starts = codec.walk_headers(buf, nseg)
    return x, codec.gather_segments(buf, counts, starts)


@pytest.mark.parametrize("mode", ["packed", "bias", "vd"])
def test_decode_staging_matches_the_jax_decode_kernel(mode, monkeypatch):
    monkeypatch.setattr(jup, "_GROUP", 1)
    k, length, nseg = 3, 2400, 2
    x, words = _streams(k, length, nseg, 0)
    j, sb = jup.codewords_per_word(k), jup._sublane_factor(nseg)
    wc = jup._chunk_words(j, sb, heavy=mode == "vd")
    want, _ovf = jup._kernel_program(
        jnp.asarray(words), k, True, sb, wc, j, True, True, length,
        tiled=True, bias=mode == "bias", vd=mode == "vd")
    want = want if mode == "vd" else (want,)
    got = decode_staging(torch.from_numpy(x), k, words.shape[1], j, wc, sb,
                         mode)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        # the TPU kernel also decodes the zero words of its padding lanes
        np.testing.assert_array_equal(
            untile(g, nseg, sb).numpy(),
            untile(torch.from_numpy(np.array(w)), nseg, sb).numpy())


@pytest.mark.parametrize("mode", ["packed", "bias", "vd"])
def test_decode_staging_concentrates_to_the_samples(mode):
    """Staging built from real streams at the JAX decode's chunking
    concentrates back into the samples, in both packages."""
    k, length = 3, 3000
    x, words = _streams(k, length, 3, 1)
    w = words.shape[1]
    j, sb = jup.codewords_per_word(k), jup._sublane_factor(3)
    wc = jup._chunk_words(j, sb, heavy=mode == "vd")
    planes = decode_staging(torch.from_numpy(x), k, w, j, wc, sb, mode)
    assert planes[0].shape == (1, -(-w // wc) * wc * j * sb, 128)
    if mode == "vd":
        got = concentrate_tiled_vd(*planes, length, sb)
        want = np.asarray(jax_tiled_vd(
            *(jnp.asarray(p.numpy()) for p in planes), length, sb,
            int(planes[1].max()), True))[:, : got.shape[1]]
    else:
        bias = mode == "bias"
        bound = (1 << (16 if bias else 15)) - 1
        got = concentrate_tiled(planes, length, sb, bias=bias)
        want = np.asarray(jax_tiled((jnp.asarray(planes[0].numpy()),),
                                    length, sb, bound, "int16", True, bias))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(untile(got, 3, sb)[:, :length].numpy(), x)


@pytest.mark.parametrize("nseg,w,k,mode", [
    (1024, 13312, 4, "bias"),    # an nEDM bucket: speculative biased plane
    (128, 64768, 3, "vd"),       # a NOPTREX bucket
    (1024, 1280, 3, None),       # a Nab bucket: untiled packed plane (B3)
    (300, 2000, 3, None),        # slot axis and bound under 2^15 (B3)
    (1024, 20000, 15, "packed"),
    (3, 3000, 1, "bias"),
    (64, 400000, 0, None),       # past the vd slot cap
])
def test_staging_route_follows_the_jax_layout_rules(nseg, w, k, mode):
    route = staging_route(nseg, w, k)
    assert (route and route[0]) == mode
    if route:
        _mode, j, wc, sb = route
        assert j == jup.codewords_per_word(k)
        assert sb == jup._sublane_factor(nseg)
        assert wc == jup._chunk_words(j, sb, heavy=mode == "vd")
