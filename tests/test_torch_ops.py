"""The port's plain torch ops (``deltarice_tpu_torch.ops``) against the JAX
package's, on the CPU.

Inputs are made from seeds with numpy and go through both; every result
must be equal exactly (tolerance 0: the codec is integer and lossless).
The port's kernel wrappers get CPU tensors here, so they run their plain
versions; the kernels themselves are held against those plain versions on
the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltarice_tpu.codec import _decode_segments_scan, _encode_segments_xla
from deltarice_tpu.config import RiceConfig as JaxConfig
from deltarice_tpu.ops import pack_xla as jpack
from deltarice_tpu.ops import prefilter as jpre
from deltarice_tpu.ops import rice as jrice
from deltarice_tpu.ops.concentrate import concentrate as jconcentrate
from deltarice_tpu_torch.config import RiceConfig
from deltarice_tpu_torch.ops import pack_ref, prefilter, rice
from deltarice_tpu_torch.ops.concentrate_cuda import (
    DEAD,
    concentrate_packed,
    staged_planes,
)
from deltarice_tpu_torch.ops.pack_cuda import pack_encode
from deltarice_tpu_torch.ops.transpose_cuda import transpose2d
from deltarice_tpu_torch.ops.unpack_cuda import unpack_decode

ALL_INT16 = np.arange(-32768, 32768, dtype=np.int16)


def _walk(rows, length, sigma, seed):
    rng = np.random.default_rng(seed)
    return np.cumsum(np.round(rng.normal(0, sigma, (rows, length))),
                     axis=-1).astype(np.int16)


def _uniform(rows, length, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-32768, 32768, (rows, length)).astype(np.int16)


def _mixed(rows=16, length=4096):
    """Random walks at several scales plus escape-heavy rows."""
    x = _walk(rows, length, 8.0, 0)
    x[1] = _walk(1, length, 0.4, 1)[0]
    x[2] = _walk(1, length, 300.0, 2)[0]
    x[3::4] = _uniform(len(x[3::4]), length, 3)
    return x


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


def test_zigzag_and_codewords_all_int16_values():
    x = torch.from_numpy(ALL_INT16)
    u = rice.zigzag(x)
    np.testing.assert_array_equal(_np(u), np.asarray(jrice.zigzag(ALL_INT16)))
    np.testing.assert_array_equal(_np(rice.unzigzag(u)), ALL_INT16)
    ju = jrice.zigzag(ALL_INT16)
    for k in range(16):
        lens, vals = rice.codeword_lengths_values(u, k)
        jl, jv = jrice.codeword_lengths_values(ju, k)
        np.testing.assert_array_equal(_np(lens), np.asarray(jl))
        np.testing.assert_array_equal(_np(vals), np.asarray(jv))


FILTERS = [(1, -1), (1,), (1, -2, 1), (3, 5, -7), (-1, 1), (2, 1),
           (1, 70000, -3)]


@pytest.mark.parametrize("filt", FILTERS, ids=str)
def test_prefilter_encode_matches_jax(filt):
    x = _mixed(6, 300)
    x[0, :8] = [-32768, 32767, -32768, 0, 32767, 1, -1, 0]
    got = prefilter.prefilter_encode(torch.from_numpy(x), filt)
    np.testing.assert_array_equal(
        _np(got), np.asarray(jpre.prefilter_encode(jnp.asarray(x), filt)))


def test_delta_prefilter_prev0_matches_jax():
    x = _mixed(6, 300)
    p0 = _uniform(1, 6, 9)[0].astype(np.int32)
    got = prefilter.prefilter_encode(torch.from_numpy(x), (1, -1),
                                     torch.from_numpy(p0))
    want = jpre.prefilter_encode(jnp.asarray(x), (1, -1), jnp.asarray(p0))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("filt", FILTERS + [(-1,), (3,), (65536, -1), (65536,)],
                         ids=str)
def test_prefilter_decode_matches_jax(filt):
    # exact inverse where |filt[0]| == 1; the reference's truncating
    # division elsewhere — the port must reproduce both, and a leading tap
    # that wraps to 0 gives -1 everywhere (XLA's division by zero)
    d = _mixed(4, 200)
    got = prefilter.prefilter_decode(torch.from_numpy(d), filt)
    want = jpre.prefilter_decode(jnp.asarray(d), filt)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("data", ["mixed", "all_int16"])
def test_pack_bits_matches_jax_all_k(data):
    # one input shape and width for every k: the JAX packer compiles once
    x = _mixed() if data == "mixed" else ALL_INT16.reshape(16, 4096)
    nv = np.full(16, 4096, np.int64)
    nv[5], nv[9] = 0, 1234
    mask = np.arange(4096)[None, :] < nv[:, None]
    u = rice.zigzag(torch.from_numpy(x))
    width = JaxConfig(1).max_words(4096)
    for k in range(16):
        lens, vals = rice.codeword_lengths_values(u, k)
        lens = torch.where(torch.from_numpy(mask), lens, 0)
        words, nwords, nbits = pack_ref.pack_bits(lens, vals, width)
        jw, jn = jpack.pack_bits(jnp.asarray(_np(lens), jnp.int32),
                                 jnp.asarray(_np(vals), jnp.uint32), width)
        np.testing.assert_array_equal(_np(words).view(np.uint32),
                                      np.asarray(jw))
        np.testing.assert_array_equal(_np(nwords), np.asarray(jn))
        np.testing.assert_array_equal(_np(nbits), _np(lens).sum(axis=1))


@pytest.mark.parametrize("k,cap", [(0, 300), (3, 40), (3, 391), (8, 7), (15, 200)])
def test_pack_encode_matches_encode_segments_xla(k, cap):
    """The B1 wrapper's plain version against ``_encode_segments_xla``:
    words (truncated at the cap), exact nwords and nbits, for whole and
    short segments, with and without a delta seed and prefiltered."""
    x = _mixed(12, 500)
    nv = np.array([500, 0, 1, 499, 250, 500, 33, 500, 500, 64, 500, 7], np.int32)
    p0 = _uniform(1, 12, 4)[0].astype(np.int32)
    cfg = JaxConfig(1 << k, 500)
    for diff, prev0 in [(True, None), (True, p0), (False, None)]:
        words, nwords, nbits = pack_encode(
            torch.from_numpy(x), torch.from_numpy(nv),
            None if prev0 is None else torch.from_numpy(prev0), k, diff, cap)
        jw, jn, jb = _encode_segments_xla(
            jnp.asarray(x), jnp.asarray(nv), cfg, cap, "segsum",
            None if prev0 is None else jnp.asarray(prev0), not diff)
        np.testing.assert_array_equal(_np(words).view(np.uint32),
                                      np.asarray(jw))
        np.testing.assert_array_equal(_np(nwords), np.asarray(jn))
        np.testing.assert_array_equal(_np(nbits), np.asarray(jb))


@pytest.mark.parametrize("m,filt", [(8, (1, -1)), (1, (1, -1)), (1 << 15, (1, -1)),
                                    (16, (1, -2, 1))], ids=str)
def test_unpack_decode_matches_decode_segments_scan(m, filt):
    """The B2 wrapper's plain version (plus the IIR inverse for generic
    filters) against ``_decode_segments_scan`` — including samples decoded
    past each stream's end (clamped cursor), which must agree too."""
    cfg = JaxConfig(m, 400, filt)
    x = _mixed(8, 400)
    nv = np.array([400, 400, 17, 400, 0, 400, 399, 400], np.int32)
    jw, jn, _ = _encode_segments_xla(jnp.asarray(x), jnp.asarray(nv), cfg,
                                     cfg.max_words(400) + 1)
    words = np.array(jw)
    got = unpack_decode(torch.from_numpy(words.view(np.int32)), 450, cfg.k,
                        cfg.is_delta)
    if not cfg.is_delta:
        got = prefilter.prefilter_decode(got, filt)
    want = np.asarray(_decode_segments_scan(jnp.asarray(words), 450, cfg))
    np.testing.assert_array_equal(_np(got), want)
    for r in range(8):
        np.testing.assert_array_equal(_np(got)[r, : nv[r]], x[r, : nv[r]])


def _sorted_with_gaps(rows, r, seed):
    """Random live slots with destinations = rank (conflict-free, monotone)
    and 16-bit payloads."""
    rng = np.random.default_rng(seed)
    live = rng.random((rows, r)) < rng.uniform(0.05, 0.95, (rows, 1))
    dest = np.cumsum(live, axis=1) - 1
    disp = np.where(live, np.arange(r)[None, :] - dest, -1).astype(np.int32)
    vals = rng.integers(0, 1 << 16, (rows, r)).astype(np.int32)
    return live, disp, vals


@pytest.mark.parametrize("r", [2, 37, 1000, 4500])
def test_concentrate_matches_jax(r):
    # (from R = 2: with one slot the XLA butterfly runs no pass and leaves
    # a dead slot's payload in place, where the kernels' contract is zero)
    live, disp, vals = _sorted_with_gaps(6, r, r)
    lo = np.random.default_rng(r + 1).integers(0, 1 << 16, (6, r)).astype(np.int32)
    n_out = r + 5
    lead = np.where(live, (disp << 16) | vals, DEAD).astype(np.int32)
    follow = ((lo + 0x8000) % 0x10000 - 0x8000).astype(np.int16)
    narrow = concentrate_packed((torch.from_numpy(lead),), n_out, False)
    jhi = np.asarray(jconcentrate(jnp.asarray(vals), jnp.asarray(disp), n_out))
    np.testing.assert_array_equal(_np(narrow), jhi)
    wide = concentrate_packed((torch.from_numpy(lead), torch.from_numpy(follow)),
                              n_out, True)
    jlo = np.asarray(jconcentrate(jnp.asarray(lo), jnp.asarray(disp), n_out))
    want = ((jhi.astype(np.uint32) << 16) | jlo.astype(np.uint32))
    np.testing.assert_array_equal(_np(wide).view(np.uint32), want)


def test_concentrate_of_encoder_staging_returns_the_stream():
    """B3 on staging laid out as the TPU encoder lays it out (slot = sample
    index, one live slot per completed word, tail word past the last
    sample) gives back the packed stream."""
    x = torch.from_numpy(_mixed(8, 700))
    lens, _ = rice.codeword_lengths_values(
        rice.zigzag(prefilter.prefilter_encode(x)), 3)
    nv = torch.full((8,), 700, dtype=torch.int32)
    words, nwords, _ = pack_encode(x, nv, None, 3, True, 547)
    lead, follow = staged_planes(lens, words, 1024)
    np.testing.assert_array_equal(
        _np(concentrate_packed((lead, follow), 547, True)), _np(words))
    live = _np(lead) != DEAD
    np.testing.assert_array_equal(live.sum(axis=1), _np(nwords))


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32, torch.uint32], ids=str)
def test_transpose_plain_matches_numpy(dtype):
    x = _uniform(37, 129, 5).astype(np.int32)
    t = torch.from_numpy(x)
    t = t.to(torch.int16) if dtype == torch.int16 else t.view(dtype)
    got = transpose2d(t)
    assert got.is_contiguous() and got.dtype == dtype
    if dtype == torch.uint32:  # numpy reads torch's uint32 through int32
        got, t = got.view(torch.int32), t.view(torch.int32)
    np.testing.assert_array_equal(_np(got), _np(t).T)


def test_wrappers_validate_and_refuse_other_devices():
    xt = torch.zeros((4, 16), dtype=torch.int16)
    nv = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        pack_encode(xt.to(torch.int32), nv, None, 3, True, 8)
    with pytest.raises(ValueError):
        pack_encode(xt, nv[:3], None, 3, True, 8)
    with pytest.raises(ValueError):
        pack_encode(xt, nv, None, 16, True, 8)
    with pytest.raises(ValueError):
        unpack_decode(torch.zeros((4, 0), dtype=torch.int32), 4, 3)
    with pytest.raises(ValueError):
        concentrate_packed((torch.zeros((2, 4), dtype=torch.int32),), 4, True)
    # a device that is neither the card nor the CPU has no plain fallback
    with pytest.raises(ValueError, match="unsupported device"):
        transpose2d(torch.empty((2, 2), dtype=torch.int16, device="meta"))


def test_config_k_and_bounds_match_jax():
    for m in [1 << k for k in range(16)]:
        a, b = RiceConfig(m, 100), JaxConfig(m, 100)
        assert (a.k, a.max_bits_per_sample(), a.max_words(7000)) == (
            b.k, b.max_bits_per_sample(), b.max_words(7000))


# --- the TPU's rate and service modes of B1 and B2 ------------------------
#
# The JAX encode kernel can stage one slot per R samples (rate 2, 4) and the
# decode kernel can serve fewer codeword starts per word than the static
# bound (j_eff); both shrink the TPU's staging and flag the rows that did
# not fit for an exact re-do, and neither changes a word of a stream or a
# decoded sample. The port's B1 and B2 store at final offsets and are exact
# at every rate: their plain versions must equal the JAX kernels (run in
# interpret mode) on every row the JAX kernel did not flag.


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Every ``pallas_call`` in interpret mode (overriding explicit
    ``interpret=False``, as in ``transpose2d``), and the decode kernel's
    unrolled word loop at one word per step (compile time only)."""
    import jax.experimental.pallas as pl
    from deltarice_tpu.ops import unpack_pallas

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    monkeypatch.setattr(unpack_pallas, "_GROUP", 1)


@pytest.mark.parametrize("rate", [2, 4])
def test_pack_plain_covers_the_jax_encode_rates(pallas_interpret, rate):
    from deltarice_tpu.ops.pack_pallas import pack_encode_pallas_bits

    k, length = 3, 1000
    x = _walk(8, length, 8.0, 0)
    x[5:] = _uniform(3, length, 1)  # dense rows: overrun the rate, flag
    nv = np.full(8, length, np.int32)
    mw = RiceConfig(1 << k).max_words(length)
    words, nwords, nbits, bad = pack_encode_pallas_bits(
        jnp.asarray(x), jnp.asarray(nv), k, mw, True, None, rate)
    wt, nwt, nbt = pack_encode(torch.from_numpy(x), torch.from_numpy(nv),
                               None, k, True, mw)
    bad = np.asarray(bad)
    assert bad[5:].all() and not bad[:5].any()
    np.testing.assert_array_equal(np.asarray(nwords), _np(nwt))
    np.testing.assert_array_equal(np.asarray(nbits), _np(nbt))
    np.testing.assert_array_equal(np.asarray(words).view(np.int32)[~bad],
                                  _np(wt)[~bad])


@pytest.mark.parametrize("j,flags", [(2, True), (4, False)])
def test_unpack_plain_covers_the_jax_service_rates(pallas_interpret, j,
                                                   flags):
    from deltarice_tpu.ops.unpack_pallas import unpack_decode_pallas

    k, length = 3, 512
    x = _walk(8, length, 30.0, 3)  # about 2.6 codeword starts per word
    x[4:] = _walk(4, length, 60.0, 4)  # under 2
    cap = RiceConfig(1 << k).max_words(length) + 1
    wt, nwt, _ = pack_encode(torch.from_numpy(x),
                             torch.full((8,), length, dtype=torch.int32),
                             None, k, True, cap)
    starts = length / _np(nwt)
    assert (starts[:4] > 2).all() and (starts < 4).all()
    words = _np(wt).view(np.uint32)
    out, bad = unpack_decode_pallas(jnp.asarray(words), length, k, True,
                                    True, j)
    plain = _np(unpack_decode(wt, length, k, True))
    bad = np.asarray(bad)
    assert bad.any() == flags and not bad.all()
    np.testing.assert_array_equal(plain, x)
    np.testing.assert_array_equal(np.asarray(out)[~bad], plain[~bad])
