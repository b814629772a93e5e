"""The port's long-segment path against the JAX package, on the CPU.

Sub-block split encode (policy, layout, host and device sub-stream merges),
the concentration router with B5 and B6, and the speculative split decode
(B9's plain version, the junction checks and the ragged merge). Inputs are
made from numpy seeds and go through both packages; every comparison is
exact (tolerance 0: the codec is integer and lossless). The kernels' plain
versions run here because the tensors lie on the CPU; the kernels
themselves are held against them on the card by
``tests/test_torch_cuda.py``.

B9's plain version is held against JAX's ``_split_kernel_program`` in
interpret mode (entry and exit phases, local counts, final delta states,
local samples and the flags they make) with the kernel's unroll constant
``_GROUP`` set to 1. That constant only sets how many words one loop step
of the TPU kernel unrolls; at 1 the interpret-mode compile takes seconds
instead of many minutes. B9 is also held through the scan oracle
(``_decode_segments_scan``) on whole streams.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import deltarice_tpu as drt
import deltarice_tpu.codec as jcodec
from deltarice_tpu.config import RiceConfig as JaxConfig
from deltarice_tpu.models import get_profile as jax_profile
from deltarice_tpu.ops import split_decode as jsplit
from deltarice_tpu.ops.concentrate import concentrate as jconcentrate
from deltarice_tpu.ops.concentrate_pallas import (
    _concentrate_wide,
    _concentrate_wide16,
    concentrate_pallas,
    concentrate_tiled as jax_tiled,
)
import deltarice_tpu_torch as dt
from deltarice_tpu_torch import codec, native
from deltarice_tpu_torch.models import get_profile
from deltarice_tpu_torch.native import native_compress, native_decompress
from deltarice_tpu_torch.ops import split_decode as tsplit
from deltarice_tpu_torch.ops.concentrate import concentrate
from deltarice_tpu_torch.ops.concentrate_cuda import (
    DEAD,
    concentrate_wide,
    concentrate_wide16,
)
from deltarice_tpu_torch.ops.concentrate_tiled_cuda import untile
from deltarice_tpu_torch.ops.split_decode_cuda import split_decode

CPU = "cpu"


def _cfg(cd):
    return dt.RiceConfig.from_cd_values(cd), JaxConfig.from_cd_values(cd)


def _walk(shape, sigma, seed):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(0, sigma, shape).round(), -1).astype(np.int16)


def _t(a):
    """numpy -> torch, uint32 as int32 bit patterns."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


# --- split policy and layout ---------------------------------------------


@pytest.mark.parametrize("nseg,length,cd,want", [
    (1024, 7000, (8,), 1),             # short: no split
    (256, 500000, (8,), 16),           # NOPTREX, whole batch
    (1024, 81920, (8,), 4),            # nEDM, whole batch -> packed
    (256, 500000, (8, -1, 3, 1, -2, 1), 16),  # FIR splits too
    (32, 81920, (16, 81920), 8),       # one nEDM chunk (32, 81920)
    (32, 500000, (8, 500000), 32),     # one NOPTREX chunk (32, 500000)
    (3, 30000, (8, 30000), 2),
])
def test_split_parts_matches_jax(nseg, length, cd, want):
    cfg, jcfg = _cfg(tuple(c & 0xFFFFFFFF for c in cd))
    assert codec._split_parts(nseg, length, cfg) == want
    assert jcodec._split_parts(nseg, length, jcfg) == want


@pytest.mark.parametrize("length,parts,halo", [(40000, 4, 0), (40000, 4, 2),
                                               (30001, 8, 0), (30001, 8, 3)])
def test_split_layout_matches_jax(length, parts, halo):
    x = _walk((3, length), 9.0, length)
    nv = np.array([length, length - 777, 5000], np.int32)
    got = codec._split_layout(x, nv, parts, halo)
    want = jcodec._split_layout(x, nv, parts, halo)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]


def test_encode_prefiltered_bits_match_jax():
    cfg, jcfg = _cfg((8, 256, 3, 1, 0xFFFFFFFE, 1))
    d = _walk((6, 256), 4.0, 1)
    nv = np.array([256, 200, 0, 256, 17, 256], np.int32)
    got = codec.encode_segments_bits(d, nv, cfg, 300, prefiltered=True,
                                     device=CPU)
    want = jcodec.encode_segments_bits(jnp.asarray(d), jnp.asarray(nv), jcfg,
                                       300, "segsum", prefiltered=True)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --- sub-stream merges -------------------------------------------------------


def _substreams(rows, parts, w, seed, lo=70):
    """Random packed sub-streams, zero past each one's bits (the packer's
    zero fill), with a short last part, empty parts and an aligned bound
    (``tests/test_split_encode.py``'s device-merge cases)."""
    rng = np.random.default_rng(seed)
    words3 = rng.integers(0, 2**32, (rows, parts, w), dtype=np.uint32)
    nbits2 = rng.integers(lo, w * 32 - 40, (rows, parts)).astype(np.int64)
    nbits2[0, -1] = 17
    nbits2[1, -2:] = 0
    if parts >= 3:
        nbits2[2, 0] = ((nbits2[2, 0] + 31) // 32) * 32
    for r in range(rows):
        for p in range(parts):
            nb = int(nbits2[r, p])
            full, rem = nb // 32, nb & 31
            if rem:
                words3[r, p, full] &= np.uint32(0xFFFFFFFF) << np.uint32(
                    32 - rem)
            words3[r, p, full + (1 if rem else 0):] = 0
    return words3, nbits2


@pytest.mark.parametrize("use_native", [True, False])
def test_merge_substreams_matches_jax(use_native, monkeypatch):
    words3, nbits2 = _substreams(5, 4, 9, 7, lo=0)
    want, wnw = jcodec.merge_substreams(words3, nbits2)
    if not use_native:
        monkeypatch.setattr(native, "_codec_lib", None)
    got, nw = codec.merge_substreams(words3, nbits2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(nw, wnw)


@pytest.mark.parametrize("rows,parts,w,seed", [
    (16, 16, 600, 1), (8, 4, 3000, 2), (32, 8, 130, 3),
    (4, 16, 2100, 4),  # parts * w >= 2^15: the wide (B5) route
])
def test_device_merge_matches_jax(rows, parts, w, seed):
    words3, nbits2 = _substreams(rows, parts, w, seed)
    nw = (nbits2.sum(axis=1) + 31) >> 5
    out_w = -(-max(int(nw.max()) + 1, parts) // 256) * 256
    got = codec._merge_device(_t(words3), torch.from_numpy(nbits2), out_w)
    want = np.asarray(jcodec._merge_device(jnp.asarray(words3),
                                           jnp.asarray(nbits2), out_w, True))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    host, _ = jcodec.merge_substreams(words3, nbits2)
    maxw = int(nw.max())
    np.testing.assert_array_equal(want[:, :maxw], host)


def test_device_merge_keeps_a_full_width_tail():
    """A sub-stream that fills every word of the widest stream, entered at
    a bit phase, spills one word further; the merge's shifted plane is one
    word wider than the widest sub-stream, so that word survives."""
    rng = np.random.default_rng(0)
    w = 256
    words = np.zeros((2, 2 * w), np.uint32)
    words[0, :2] = rng.integers(0, 2**32, 2, dtype=np.uint32)
    words[0, 1] &= np.uint32(0xFF000000)
    words[1, :w] = rng.integers(0, 2**32, w, dtype=np.uint32)
    nbits2 = np.array([[40, 32 * w]], np.int64)
    got, nw = codec.merge_substreams_device(_t(words), nbits2, 2)
    want, wnw = jcodec.merge_substreams(words.reshape(1, 2, 2 * w), nbits2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(nw, wnw)


def test_device_merge_declines_a_short_middle_part():
    words3, nbits2 = _substreams(4, 4, 40, 5)
    nbits2[3, 1] = 20  # a middle part inside one output word
    words = words3.reshape(16, 40)
    assert codec.merge_substreams_device(_t(words), nbits2, 4) is None


# --- concentration: B5, B6 and the router ------------------------------------


def _planes(rows, r, density, seed, dtype=np.int16):
    """Random monotone conflict-free (values, disp, n_out)."""
    rng = np.random.default_rng(seed)
    valid = rng.random((rows, r)) < density
    dest = np.cumsum(valid, axis=1) - 1
    disp = np.where(valid, np.arange(r)[None, :] - dest, -1).astype(np.int32)
    info = np.iinfo(dtype)
    vals = rng.integers(info.min, info.max + 1, (rows, r)).astype(dtype)
    return vals, disp, max(int(valid.sum(axis=1).max()), 1)


@pytest.mark.parametrize("r,dtype", [(40000, np.int16), (70000, np.uint32),
                                     (5000, np.uint32)])
def test_concentrate_wide_matches_jax(r, dtype):
    vals, disp, n_out = _planes(8, r, 0.35, r, dtype)
    got = concentrate_wide(_t(vals), _t(disp), n_out + 7)
    want = np.asarray(_concentrate_wide(jnp.asarray(vals), jnp.asarray(disp),
                                        n_out + 7, True))
    xla = np.asarray(jconcentrate(jnp.asarray(vals), jnp.asarray(disp),
                                  n_out + 7))
    np.testing.assert_array_equal(want, xla)
    np.testing.assert_array_equal(got.numpy(), want.view(got.numpy().dtype))


def test_concentrate_wide_huge_displacement():
    """A lone live element at the far right routes across every block."""
    r = 70000
    vals = np.zeros((8, r), np.int16)
    disp = np.full((8, r), -1, np.int32)
    vals[:, r - 1] = np.arange(8) + 7
    disp[:, r - 1] = r - 1
    got = concentrate_wide(_t(vals), _t(disp), 4)
    want = np.asarray(_concentrate_wide(jnp.asarray(vals), jnp.asarray(disp),
                                        4, True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert list(got[:, 0].numpy()) == list(range(7, 15))


def _biased(vals, disp):
    return np.where(disp >= 0, ((disp.astype(np.int64) << 16)
                                | (vals.astype(np.int64) & 0xFFFF))
                    ^ (1 << 31), DEAD & 0xFFFFFFFF).astype(np.uint32)


@pytest.mark.parametrize("r,density", [(40000, 0.9), (49152, 0.5),
                                       (3000, 0.35)])
def test_concentrate_wide16_matches_jax(r, density):
    vals, disp, n_out = _planes(8, r, density, r)
    bound = int(disp.max())
    assert bound < (1 << 16)
    got = concentrate_wide16(_t(_biased(vals, disp)), n_out)
    want = np.asarray(_concentrate_wide16(jnp.asarray(vals), jnp.asarray(disp),
                                          n_out, bound, True))
    np.testing.assert_array_equal(
        (((got.numpy() & 0xFFFF) ^ 0x8000) - 0x8000).astype(np.int16), want)


def test_concentrate_wide16_dead_collision():
    """A live 0 at displacement 0 equals the dead marker and reads 0."""
    vals = np.zeros((8, 40000), np.int16)
    disp = np.full((8, 40000), -1, np.int32)
    disp[:, 0] = 0
    vals[:, 5] = 1234  # a live neighbour keeps its value
    disp[:, 5] = 4
    got = concentrate_wide16(_t(_biased(vals, disp)), 4)
    want = np.asarray(_concentrate_wide16(jnp.asarray(vals), jnp.asarray(disp),
                                          4, 30000, True))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    assert got[:, 0].eq(0).all() and got[:, 1].eq(1234).all()


@pytest.mark.parametrize("r,dtype,bound", [
    (3000, np.int16, None),      # packed leader (B3)
    (3000, np.uint32, None),     # packed leader + follower (B3)
    (40000, np.int16, "max"),    # wide, 16-bit, bounded: one plane (B6)
    (40000, np.int16, None),     # wide, no bound: two planes (B5)
    (40000, np.uint32, None),    # wide, 32-bit: two planes (B5)
])
def test_router_matches_jax(r, dtype, bound):
    vals, disp, n_out = _planes(8, r, 0.4, r + 1, dtype)
    b = int(disp.max()) if bound else None
    got = concentrate(_t(vals), _t(disp), n_out, b)
    want = np.asarray(concentrate_pallas(jnp.asarray(vals), jnp.asarray(disp),
                                         n_out, b, True))
    np.testing.assert_array_equal(got.numpy(), want.view(got.numpy().dtype))


# --- split decode --------------------------------------------------------------


@pytest.mark.parametrize("nseg,wmax,k", [
    (256, 80640, 3), (1024, 15700, 4), (1024, 1408, 3), (1024, 5632, 3),
    (1024, 2990, 1), (8, 640, 3), (1024, 13100, 4), (256, 62700, 3),
])
def test_split_router_matches_jax(nseg, wmax, k):
    assert tsplit.decode_split_parts(nseg, wmax, k) == (
        jsplit.decode_split_parts(nseg, wmax, k))


def test_halo_and_local_width_match_jax():
    for spw in (0.1, 0.5, 1.3, 3.0, 6.2, 8.0, 40.0):
        assert tsplit._halo_words(spw) == jsplit._halo_words(spw)
    for n, parts in ((500000, 32), (81920, 4), (20000, 4), (100, 64)):
        assert tsplit._local_width(n, parts) == jsplit._local_width(n, parts)


@pytest.mark.parametrize("delta", [True, False])
def test_compose_merge_matches_jax(delta):
    rng = np.random.default_rng(3)
    nseg, parts, lw, n_samples = 6, 4, 256, 900
    rows = nseg * parts
    local = rng.integers(-32768, 32768, (rows, lw)).astype(np.int16)
    ext = rng.integers(0, 25, rows).astype(np.int32)
    ent = np.roll(ext, 1).astype(np.int32)  # every junction matches ...
    ent[5] += 1                             # ... but segment 1's second
    nloc = rng.integers(200, 240, rows).astype(np.int32)
    nloc[9] = 300                           # an overrun in segment 2
    accf = rng.integers(-32768, 32768, rows).astype(np.int32)
    wv2 = rng.integers(1, 50, (nseg, parts)).astype(np.int32)
    wv2[4, 2:] = 0                          # an empty suffix in segment 4
    nv = np.minimum(nloc.reshape(nseg, parts).sum(axis=1) - 3,
                    n_samples).astype(np.int32)
    nv[3] = 10_000                          # more samples than decoded
    args = (local, ent, ext, nloc, accf, wv2, nv)
    got, bad = tsplit._compose_merge(*map(_t, args), n_samples, parts, lw,
                                     delta)
    want, wbad = jsplit._compose_merge(*map(jnp.asarray, args), n_samples,
                                       parts, lw, delta, True)
    np.testing.assert_array_equal(bad.numpy(), np.asarray(wbad))
    assert list(bad.numpy()) == [False, True, True, True, False, False]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _gathered(x, cfg):
    """Port-encoded streams of x, gathered as the decoder does."""
    blob = dt.compress(x, cfg, device=CPU)
    buf = np.frombuffer(blob, dtype="<u4")
    nseg, length, nvalid = codec._segment_layout(x.size, cfg)
    counts, starts = codec.walk_headers(buf, nseg)
    return blob, codec.gather_segments(buf, counts, starts), counts, nvalid


@pytest.mark.parametrize("k,sigma,parts,rows,total", [
    (3, 8.0, 4, 2, 40000),
    (4, 16.0, 8, 2, 40000),
    (1, 1.5, 4, 2, 40000),
    (3, 8.0, 4, 1, 47531),   # two full segments and a leftover
])
def test_split_decode_matches_scan_oracle(k, sigma, parts, rows, total):
    length = 20000
    x = _walk((rows, total // rows), sigma, k)
    cfg, jcfg = _cfg((1 << k, length))
    _blob, words, counts, nvalid = _gathered(x, cfg)
    out, bad = tsplit.unpack_decode_split(_t(words), counts, length, k,
                                          True, parts, nvalid)
    assert not bad.any()
    ref = np.asarray(jcodec._decode_segments_scan(jnp.asarray(words), length,
                                                  jcfg))
    for i, nv in enumerate(nvalid):
        np.testing.assert_array_equal(out[i, :nv].numpy(), ref[i, :nv])


@pytest.mark.parametrize("seed,length,flagged", [(0, 12000, 2),
                                                (4, 6000, 1)])
def test_split_kernel_matches_jax(seed, length, flagged, monkeypatch):
    """B9 against ``_split_kernel_program`` on NOPTREX-like streams cut
    into 4 parts at the JAX halo, where some junctions do not resync."""
    monkeypatch.setattr(jsplit, "_GROUP", 1)
    k, parts, nseg = 3, 4, 8
    x = get_profile("noptrex").synthetic(nseg, seed=seed, length=length)
    cfg = dt.RiceConfig(1 << k, length)
    _blob, words, counts, nvalid = _gathered(x, cfg)
    wsub = -(-int(counts.max()) // parts)
    halo = tsplit._halo_words(length / counts.mean())
    lw = tsplit._local_width(length, parts)
    width = halo + wsub + jsplit._TAIL
    wq = np.pad(words, ((0, 0), (halo, parts * wsub + width)))
    subs = np.stack([wq[:, p * wsub : p * wsub + width]
                     for p in range(parts)], axis=1).reshape(-1, width)
    wv2 = np.clip(counts[:, None] - np.arange(parts)[None, :] * wsub, 0,
                  wsub).astype(np.int32)
    first = np.zeros((nseg, parts), np.int32)
    first[:, 0] = 1
    j = jsplit.codewords_per_word(k)
    plane_t, *jmeta = jsplit._split_kernel_program(
        jnp.asarray(subs), jnp.asarray(wv2.reshape(-1)),
        jnp.asarray(first.reshape(-1)), k, True, halo, j, True)
    local, meta = split_decode(_t(words), torch.from_numpy(wv2.reshape(-1)),
                               parts, wsub, halo, lw, k, True)
    for got, want in zip(meta, jmeta):  # ent, ext, nloc, accf
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    wc = jsplit._chunk_words(j)
    bound = (-(-width // wc) * wc - 1) * (j - 1) + halo + j
    jlocal = untile(torch.from_numpy(np.array(jax_tiled(
        (plane_t,), lw, 8, bound, "int16", True))), nseg * parts, 8)[:, :lw]
    np.testing.assert_array_equal(local.numpy(), jlocal.numpy())
    nv = nvalid.astype(np.int32)
    out, bad = tsplit._compose_merge(local, *meta, torch.from_numpy(wv2),
                                     torch.from_numpy(nv), length, parts, lw,
                                     True)
    jout, jbad = jsplit._compose_merge(jnp.asarray(jlocal.numpy()),
                                       *jmeta, jnp.asarray(wv2),
                                       jnp.asarray(nv), length, parts, lw,
                                       True, True)
    np.testing.assert_array_equal(bad.numpy(), np.asarray(jbad))
    assert int(bad.sum()) == flagged
    ok = ~bad.numpy()
    np.testing.assert_array_equal(out.numpy()[ok], np.asarray(jout)[ok])
    np.testing.assert_array_equal(out.numpy()[ok], x[ok])


def _never_sync(rows, length):
    """1, 0, -1, -2, ... at k=1: every codeword after the first is '11', so
    true boundaries sit on odd bit offsets while each sub-block's
    speculation starts at an even one and parses off-lattice forever
    (``tests/test_split_decode.py:101``)."""
    x = (1 - np.arange(length, dtype=np.int64)).astype(np.int16)
    return np.broadcast_to(x, (rows, length)).copy()


def test_never_sync_stream_flags_and_decompress_recovers(monkeypatch):
    x = _never_sync(2, 20000)
    cfg = dt.RiceConfig(2, 20000)
    blob, words, counts, nvalid = _gathered(x, cfg)
    _out, bad = tsplit.unpack_decode_split(_t(words), counts, 20000, 1,
                                           True, 4, nvalid)
    assert bad.all()
    # end to end with the switch on; a two-segment batch is far below the
    # router's lane target, so the router is held at 4 parts here
    monkeypatch.setenv("DELTARICE_TPU_SPLIT_DECODE", "1")
    calls = []

    def four(nseg, wmax, k):
        calls.append(nseg)
        return 4

    monkeypatch.setattr(codec, "decode_split_parts", four)
    np.testing.assert_array_equal(dt.decompress(blob, cfg, device=CPU),
                                  x.ravel())
    assert calls == [2]


def test_split_switch_reads_the_jax_variable(monkeypatch):
    monkeypatch.delenv("DELTARICE_TPU_SPLIT_DECODE", raising=False)
    assert not codec._split_decode_enabled()
    monkeypatch.setenv("DELTARICE_TPU_SPLIT_DECODE", "1")
    assert codec._split_decode_enabled()


# --- the slice as a whole ------------------------------------------------------


@pytest.mark.parametrize("cd", [
    (8, 40000),                               # P=4 sub-blocks per segment
    (8, 40000, 3, 1, 0xFFFFFFFE, 1),          # FIR (1, -2, 1), halo split
    (8, 30000),                               # leftover segment of 20000
], ids=["delta", "fir", "leftover"])
def test_split_compress_batch_matches_jax_and_native(cd, monkeypatch):
    cfg, jcfg = _cfg(cd)
    x = _walk((2, 40000), 6.0, 11)
    nseg, length, _nv = codec._segment_layout(x.size, cfg)
    assert codec._split_parts(nseg, length, cfg) > 1
    chunks = [x, x[::-1].copy()]
    streams = dt.compress_batch(chunks, cfg, device=CPU)
    for c, s in zip(chunks, streams):
        assert s == bytes(drt.compress(c, jcfg, method="segsum"))
        assert s == native_compress(c, cd)
        np.testing.assert_array_equal(native_decompress(s, cd), c.ravel())
    if cfg.is_delta:  # the split decode (switch on) returns the chunks
        monkeypatch.setenv("DELTARICE_TPU_SPLIT_DECODE", "1")
        monkeypatch.setattr(codec, "decode_split_parts", lambda *a: 4)
        back = dt.decompress_batch(streams, cfg, device=CPU)
        for c, b in zip(chunks, back):
            np.testing.assert_array_equal(b, c.ravel())


@pytest.mark.parametrize("name,rows", [("nedm", 3), ("noptrex", 2)])
def test_profile_generator_matches_jax(name, rows):
    np.testing.assert_array_equal(get_profile(name).synthetic(rows, seed=4),
                                  jax_profile(name).synthetic(rows, seed=4))
