"""Corrupt and hostile streams through the port, against the JAX package, on
the CPU: the port of ``tests/test_robustness.py``.

The contract is the JAX package's: a damaged stream gives a clean
``ValueError`` or garbage, never a crash, a hang or an out-of-bounds read.
Every case of ``tests/hostile_cases.py`` goes through the port's
``decompress`` (``device="cpu"``: the kernels' plain versions) and through
``deltarice_tpu.decompress``; both must raise ``ValueError``, or both must
return equal int16 arrays. The tolerance is 0, for garbage too: both
decoders clamp the cursor and walk the same words, so they make the same
garbage. The card's kernels are held to these plain versions on the same
cases by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

With the split switch on, the port is held to the JAX package's split
decode in interpret mode (``unpack_decode_split`` with the kernel's unroll
constant ``_GROUP`` at 1, as ``tests/test_torch_split.py`` runs it, and the
segments it flags decoded again by the exact scan), on one batch of the
flipped long-segment streams at the sizes and part count of
``tests/test_torch_split.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import deltarice_tpu as drt
import deltarice_tpu.codec as jcodec
from deltarice_tpu import h5 as jh5
from deltarice_tpu.ops import split_decode as jsplit
import deltarice_tpu_torch as dt
from deltarice_tpu_torch import codec
from deltarice_tpu_torch import h5 as th5
from deltarice_tpu_torch.models import get_profile
from deltarice_tpu_torch.native import native_decompress
from deltarice_tpu_torch.tools.memstore import MemGroup
import hostile_cases as hc

CPU = "cpu"
SPLIT_PARTS = 4  # the part count tests/test_torch_split.py forces


def _cfg(cd):
    return dt.RiceConfig.from_cd_values(cd), drt.RiceConfig.from_cd_values(cd)


def _blob(n=1000, cd=(8, 100), seed=0, sigma=10):
    """The JAX test's stream: a random walk of ``n`` samples."""
    rng = np.random.default_rng(seed)
    x = np.round(np.cumsum(rng.normal(0, sigma, n))).astype(np.int16)
    cfg, jcfg = _cfg(cd)
    blob = dt.compress(x, cfg, device=CPU)
    assert blob == bytes(drt.compress(x, jcfg))
    return x, blob, cfg, jcfg


def _port(cfg):
    return lambda s: dt.decompress(s, cfg, device=CPU)


def _jax(jcfg):
    return lambda s: drt.decompress(s, jcfg)


def _hold(cases, cfg, jcfg, cd=None):
    """Each case through both packages (and native ``dr_decompress`` where
    ``cd`` is given); returns the port's outcome kinds."""
    kinds = []
    for name, s in cases:
        got = hc.outcome(_port(cfg), s)
        want = hc.outcome(_jax(jcfg), s)
        assert hc.same(got, want), f"{name}: port {got[0]}, JAX {want[0]}"
        if got[0] == "returned":
            assert got[1].dtype == np.int16
        if cd is not None:
            nat = hc.outcome(lambda b: native_decompress(b, cd), s)
            assert hc.same(got, nat), f"{name}: native {nat[0]}"
        kinds.append(got[0])
    return kinds


FAMILIES = {
    "truncations": lambda blob, nseg: hc.truncations(blob),
    "flips": lambda blob, nseg: hc.flips(blob),
    "lying totals": lambda blob, nseg: hc.lying_totals(blob),
    "empty": lambda blob, nseg: [("empty", b"")],
    "one segment": hc.one_segment,
    "bad payloads": hc.bad_payloads,
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_corpus_matches_jax(family):
    x, blob, cfg, jcfg = _blob()
    nseg = cfg.segments(x.size)[0]
    kinds = _hold(FAMILIES[family](blob, nseg), cfg, jcfg, cd=(8, 100))
    if family in ("truncations", "empty"):
        assert set(kinds) == {"raised"}
    if family == "lying totals":  # a total of 0 decodes to no samples
        assert kinds == ["raised", "returned"]
        assert _port(cfg)(hc.lying_totals(blob)[1][1]).size == 0
    if family in ("one segment", "bad payloads"):
        assert set(kinds) == {"returned"}
    np.testing.assert_array_equal(_port(cfg)(blob), x)


@pytest.mark.parametrize("cd", [(1, 64), (32768, 256), (8, -1)], ids=str)
def test_flips_at_the_rate_extremes_match_jax(cd):
    """k = 0, k = 15 and one segment a chunk (its bucket is the stream)."""
    x, blob, cfg, jcfg = _blob(600, cd, seed=5, sigma=40)
    nseg = cfg.segments(x.size)[0]
    _hold(hc.flips(blob, 40) + hc.one_segment(blob, nseg)
          + hc.bad_payloads(blob, nseg), cfg, jcfg)


def test_corpus_as_one_batch_matches_jax():
    """Every case that survives the header walk in one ``decompress_batch``:
    the escape-wide "one segment" stream takes a bucket of its own."""
    x, blob, cfg, jcfg = _blob(seed=1)
    nseg = cfg.segments(x.size)[0]
    batch = hc.batchable([s for _n, s in hc.corpus(blob, nseg)], nseg,
                         x.size)
    assert len(batch) > 250
    got = dt.decompress_batch(batch, cfg, device=CPU)
    want = jcodec.decompress_batch(batch, jcfg)
    assert len(got) == len(want) == len(batch)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("filt", hc.GENERIC_FILTERS, ids=str)
def test_generic_filter_flips_match_jax(filt):
    """(g): the blocked inverse's filter and the serial walk's lossy one."""
    cd = (8, 100, len(filt), *[f & 0xFFFFFFFF for f in filt])
    x, blob, cfg, jcfg = _blob(cd=cd, seed=6)
    _hold(hc.flips(blob, 60), cfg, jcfg)


def _long():
    """A NOPTREX-like chunk of 8 segments of 12000 samples, M=8: the
    sizes of tests/test_torch_split.py's B9 comparison."""
    x = get_profile("noptrex").synthetic(8, seed=0, length=12000)
    cfg, jcfg = _cfg((8, 12000))
    blob = dt.compress(x, cfg, device=CPU)
    assert blob == bytes(drt.compress(x, jcfg))
    return x, blob, cfg, jcfg


def _jax_split_batch(streams, jcfg, parts):
    """The JAX package's decompress_batch with its split decode taken, in
    interpret mode: its walk, buckets and gather, ``unpack_decode_split``
    per bucket, the flagged segments decoded again by the exact scan."""
    bufs = [np.frombuffer(s, dtype="<u4") for s in streams]
    total = int(bufs[0][0])
    nseg, length, nvalid = jcodec._segment_layout(total, jcfg)
    walked = [jcodec.walk_headers(b, nseg) for b in bufs]
    buckets = {}
    for i, (counts, _starts) in enumerate(walked):
        w = -(-(int(counts.max(initial=0)) + 1) // jcodec._WORD_BUCKET)
        buckets.setdefault(w * jcodec._WORD_BUCKET, []).append(i)
    out = [None] * len(streams)
    flagged = 0
    for bucket, idxs in buckets.items():
        words = np.concatenate([jcodec.gather_segments(
            bufs[i], *walked[i], bucket) for i in idxs])
        counts = np.concatenate([walked[i][0] for i in idxs])
        dec, bad = jsplit.unpack_decode_split(
            jnp.asarray(words), counts, length, jcfg.k, jcfg.is_delta, parts,
            np.tile(nvalid, len(idxs)), interpret=True)
        dec, bad = np.array(dec), np.asarray(bad)
        flagged += int(bad.sum())
        if bad.any():
            dec[bad] = np.asarray(jcodec._decode_segments_scan(
                jnp.asarray(words[bad]), length, jcfg))
        dec = dec.reshape(len(idxs), -1)
        for j, i in enumerate(idxs):
            out[i] = dec[j, :total]
    return out, flagged


def test_long_segment_flips_match_jax_split_off_and_on(monkeypatch):
    """(h): flips in a long-segment stream and its bad payloads, split
    switch off (the exact decode against JAX's) and on (against JAX's
    split decode, flagged segments included).

    No case decodes differently with the switch on than off, in either
    package: where the split decode flags no segment, every junction met
    the serial walk, so it decodes the serial walk's codewords; a flagged
    segment is decoded again exactly."""
    monkeypatch.setattr(jsplit, "_GROUP", 1)
    x, blob, cfg, jcfg = _long()
    cases = hc.flips(blob, 40) + hc.bad_payloads(blob, 8)
    batch = hc.batchable([s for _n, s in cases], 8, x.size)
    for _name, s in cases:  # the streams left out raise in both packages
        if s not in batch:
            assert hc.outcome(_port(cfg), s)[0] == "raised"
            assert hc.outcome(_jax(jcfg), s)[0] == "raised"
    monkeypatch.setenv("DELTARICE_TPU_SPLIT_DECODE", "0")
    off = dt.decompress_batch(batch, cfg, device=CPU)
    joff = jcodec.decompress_batch(batch, jcfg)
    for g, w in zip(off, joff):
        np.testing.assert_array_equal(g, w)
    monkeypatch.setenv("DELTARICE_TPU_SPLIT_DECODE", "1")
    parts = []
    monkeypatch.setattr(codec, "decode_split_parts",
                        lambda *a: parts.append(SPLIT_PARTS) or SPLIT_PARTS)
    on = dt.decompress_batch(batch, cfg, device=CPU)
    jon, flagged = _jax_split_batch(batch, jcfg, SPLIT_PARTS)
    assert parts and flagged > 0
    for g, w in zip(on, jon):
        np.testing.assert_array_equal(g, w)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    # the intact stream decodes exactly with the switch on
    np.testing.assert_array_equal(_port(cfg)(blob), x.ravel())


def _store(x, cfg, chunks, device=CPU):
    g = MemGroup()
    th5.write_dataset(g, "d", x, cfg, chunks, batch_chunks=1, device=device)
    return g, g["d"]


@pytest.mark.parametrize("damage", ["truncated", "flipped"])
def test_h5_read_with_a_damaged_chunk_matches_jax(damage):
    """A dataset of three chunks (one a window) whose middle chunk is
    damaged: a truncation raises in both packages after the same chunks,
    a payload flip returns the same garbage; then an intact dataset reads
    back exactly in the same process."""
    rng = np.random.default_rng(8)
    x = np.round(np.cumsum(rng.normal(0, 10, (12, 200)), -1)).astype(
        np.int16)
    cfg, jcfg = _cfg((8, 200))
    _g, dset = _store(x, cfg, (4, 200))
    off = (4, 0)
    mask, blob = dset.id.read_direct_chunk(off)
    bad = blob[:-4] if damage == "truncated" else hc.flips(blob, 1, 3)[0][1]
    dset.id.write_direct_chunk(off, bad, mask)
    port_read = lambda _: th5.read_dataset(dset, cfg, 1, device=CPU)  # noqa
    jax_read = lambda _: jh5.read_dataset(dset, jcfg, 1)  # noqa
    got, want = hc.outcome(port_read, None), hc.outcome(jax_read, None)
    assert hc.same(got, want)
    assert got[0] == ("raised" if damage == "truncated" else "returned")

    def chunks_before(it):
        seen = []
        try:
            for o, c in it:
                seen.append((o, c.copy()))
        except ValueError:
            seen.append("raised")
        return seen

    seen = chunks_before(th5.iter_chunks(dset, cfg, 1, device=CPU))
    jseen = chunks_before(jh5.iter_chunks(dset, jcfg, 1))
    # a truncation raises in the second window's dispatch, before the
    # first window is collected (the pipeline is one window deep)
    assert len(seen) == len(jseen) == (1 if damage == "truncated" else 3)
    for a, b in zip(seen, jseen):
        if a == "raised" or b == "raised":
            assert a == b
        else:
            assert a[0] == b[0]
            np.testing.assert_array_equal(a[1], b[1])
    _g2, intact = _store(x, cfg, (4, 200))
    np.testing.assert_array_equal(th5.read_dataset(intact, cfg, device=CPU),
                                  x)
    np.testing.assert_array_equal(jh5.read_dataset(intact, jcfg), x)


def test_native_decoder_on_the_corpus():
    """The port's native ``dr_decompress`` (its own copy of the C sources)
    rejects every truncation and agrees with the port everywhere else —
    the counterpart of the JAX test that drives the native decoder."""
    x, blob, cfg, _jcfg = _blob(seed=4)
    nseg = cfg.segments(x.size)[0]
    for name, s in hc.corpus(blob, nseg, n_flips=60):
        nat = hc.outcome(lambda b: native_decompress(b, (8, 100)), s)
        got = hc.outcome(_port(cfg), s)
        assert hc.same(nat, got), name
        if name.startswith("cut") or name == "empty":
            assert nat[0] == "raised", name
