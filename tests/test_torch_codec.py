"""The port's codec (``deltarice_tpu_torch``) as a whole against the JAX
package, the committed golden vectors and the native C codec, on the CPU.

Every comparison is exact (tolerance 0: the codec is integer and lossless).
``device="cpu"`` runs the kernels' plain versions; the same calls with
``device="cuda"`` run on the card in ``tests/test_torch_cuda.py``.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import deltarice_tpu as drt
import deltarice_tpu.codec as jcodec
import deltarice_tpu_torch as dt
from deltarice_tpu.config import RiceConfig as JaxConfig
from deltarice_tpu.models import get_profile as jax_profile
from deltarice_tpu_torch import codec
from deltarice_tpu_torch.models import get_profile
from deltarice_tpu_torch.native import native_compress, native_decompress

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = Path(__file__).parent / "data" / "golden"
CASES = json.loads((GOLDEN / "manifest.json").read_text())
CPU = "cpu"


def _cfg(cd):
    """The same configuration on both sides, built from one cd_values."""
    return dt.RiceConfig.from_cd_values(cd), JaxConfig.from_cd_values(cd)


def _nab(rows, length, seed=0):
    return get_profile("nab").synthetic(rows, seed=seed, length=length)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_compress_matches_golden(case):
    cfg = dt.RiceConfig.from_cd_values(case["cd_values"])
    data = np.load(GOLDEN / f"{case['name']}.npy")
    assert dt.compress(data, cfg, device=CPU) == (
        GOLDEN / f"{case['name']}.bin").read_bytes()


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_decompress_matches_golden(case):
    cfg = dt.RiceConfig.from_cd_values(case["cd_values"])
    data = np.load(GOLDEN / f"{case['name']}.npy")
    golden = (GOLDEN / f"{case['name']}.bin").read_bytes()
    np.testing.assert_array_equal(dt.decompress(golden, cfg, device=CPU), data)


def test_nab_profile_matches_jax_generator():
    np.testing.assert_array_equal(_nab(8, 700, 3),
                                  jax_profile("nab").synthetic(8, 3, 700))


def test_compress_and_batch_match_jax_on_nab_data():
    cfg, jcfg = _cfg((8, 700))
    chunks = list(_nab(16, 700).reshape(4, 4, 700))
    streams = dt.compress_batch(chunks, cfg, device=CPU)
    assert streams == [bytes(s) for s in jcodec.compress_batch(chunks, jcfg)]
    assert dt.compress(chunks[1], cfg, device=CPU) == bytes(
        drt.compress(chunks[1], jcfg))
    back = dt.decompress_batch(streams, cfg, device=CPU)
    for c, b in zip(chunks, back):
        np.testing.assert_array_equal(b, c.ravel())


def test_dispatch_collect_equals_batch():
    cfg = dt.RiceConfig(8, 700)
    chunks = list(_nab(8, 700, 1).reshape(2, 4, 700))
    h = codec.compress_batch_dispatch(chunks, cfg, CPU)
    streams = codec.compress_batch_collect(h, cfg)
    assert streams == dt.compress_batch(chunks, cfg, device=CPU)
    back = codec.decompress_batch_collect(
        codec.decompress_batch_dispatch(streams, cfg, CPU))
    assert all(np.array_equal(b, c.ravel()) for b, c in zip(back, chunks))


def test_long_segment_encodes_serially_to_the_split_bytes():
    # both packages split a 20000-sample segment into sub-streams and
    # merge them at bit offsets — the bytes of the serial encode
    cfg, jcfg = _cfg((8,))
    x = _nab(1, 20000, 5)[0]
    assert jcodec._split_parts(1, 20000, jcfg) > 1
    blob = dt.compress(x, cfg, device=CPU)
    assert blob == bytes(drt.compress(x, jcfg))
    assert blob == native_compress(x, cfg.to_cd_values())
    np.testing.assert_array_equal(dt.decompress(blob, cfg, device=CPU), x)


def test_over_cap_rows_reencode_exactly():
    """Dense rows fix the word cap from a host subsample; escape-heavy rows
    outside the subsample overflow it and re-encode at the full bound."""
    cfg, jcfg = _cfg((8, 1024))
    x = _nab(128, 1024, 2)
    rng = np.random.default_rng(7)
    for r in (1, 33, 77):  # odd rows: the 64-row subsample takes even ones
        x[r] = rng.integers(-32768, 32768, 1024)
    cap = codec._words_hint(x, cfg, 1024)
    assert cap < cfg.max_words(1024)
    chunks = list(x.reshape(8, 16, 1024))
    h = codec.compress_batch_dispatch(chunks, cfg, CPU)
    assert int(h[3].max()) > cap  # some rows really overflowed
    streams = codec.compress_batch_collect(h, cfg)
    assert streams == [bytes(s) for s in jcodec.compress_batch(chunks, jcfg)]
    for c, s in zip(chunks, streams):
        assert s == native_compress(c, cfg.to_cd_values())
    back = dt.decompress_batch(streams, cfg, device=CPU)
    assert all(np.array_equal(b, c.ravel()) for b, c in zip(back, chunks))


def test_generic_filter_batch_matches_jax_and_verifies():
    cfg, jcfg = _cfg((16, 300, 3, 1, 0xFFFFFFFE, 1))
    chunks = list(_nab(6, 500, 4).reshape(3, 1000))  # leftover segment
    streams = dt.compress_batch(chunks, cfg, verify=True, device=CPU)
    assert streams == [bytes(s) for s in jcodec.compress_batch(chunks, jcfg)]
    back = jcodec.decompress_batch(streams, jcfg)
    assert all(np.array_equal(b, c) for b, c in zip(back, chunks))
    assert all(np.array_equal(native_decompress(s, cfg.to_cd_values()), c)
               for s, c in zip(streams, chunks))


def test_segment_api_matches_jax():
    cfg, jcfg = _cfg((4, 256))
    x = _nab(5, 256, 6)
    nv = np.array([256, 256, 100, 0, 256], np.int32)
    words, nwords = dt.encode_segments(x, nv, cfg, 320, device=CPU)
    jw, jn = drt.encode_segments(x, nv, jcfg, 320)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), np.asarray(jw))
    np.testing.assert_array_equal(nwords.numpy(), np.asarray(jn))
    p0 = np.random.default_rng(8).integers(-32768, 32768, 5).astype(np.int32)
    w2, n2, b2 = codec.encode_segments_bits(x, nv, cfg, 320, prev0=p0,
                                            device=CPU)
    jw2, jn2, jb2 = jcodec.encode_segments_bits(x, nv, jcfg, 320, "auto", p0)
    np.testing.assert_array_equal(w2.numpy().view(np.uint32), np.asarray(jw2))
    np.testing.assert_array_equal(n2.numpy(), np.asarray(jn2))
    np.testing.assert_array_equal(b2.numpy(), np.asarray(jb2))
    out = dt.decode_segments(np.asarray(jw), 256, cfg, device=CPU)
    assert out.dtype == torch.int16 and out.shape == (5, 256)
    np.testing.assert_array_equal(out.numpy(), np.asarray(
        drt.decode_segments(jw, 256, jcfg)))


def test_bad_input_raises_value_error():
    cfg = dt.RiceConfig(8, 100)
    assert dt.compress(b"", cfg, device=CPU) == bytes(drt.compress(b"", JaxConfig(8, 100)))
    assert dt.decompress(dt.compress(b"", cfg, device=CPU), cfg, device=CPU).size == 0
    with pytest.raises(ValueError):
        dt.compress(b"\x01\x02\x03", cfg, device=CPU)
    with pytest.raises(ValueError):
        dt.decompress(b"", cfg, device=CPU)
    blob = dt.compress(_nab(1, 550)[0], cfg, device=CPU)
    for cut in (4, 8, 40, len(blob) - 4, len(blob) - 1):
        with pytest.raises(ValueError):
            dt.decompress(blob[:cut], cfg, device=CPU)
    with pytest.raises(ValueError):
        dt.compress_batch([np.zeros(4, np.int16), np.zeros(6, np.int16)], cfg,
                          device=CPU)


CD_VALUES = [(), (16,), (8, 7000), (1 << 15, 64), (8, 0xFFFFFFFF, 1, 1),
             (4, 512, 3, 1, 0xFFFFFFFE, 1), (8, 100, 2, 0xFFFFFFFF, 1)]
BAD_CD_VALUES = [(3,), (1 << 16,), (0,), (8, 0), (8, 100, 3, 1, 2),
                 (8, 100, 1, 0), (8, 100, 0)]


@pytest.mark.parametrize("cd", CD_VALUES, ids=str)
def test_cd_values_parity_with_jax(cd):
    cfg, jcfg = _cfg(cd)
    assert (cfg.m, cfg.waveform_length, cfg.filt, cfg.k, cfg.is_delta) == (
        jcfg.m, jcfg.waveform_length, jcfg.filt, jcfg.k, jcfg.is_delta)
    assert cfg.to_cd_values() == jcfg.to_cd_values()
    assert dt.RiceConfig.from_cd_values(jcfg.to_cd_values()) == cfg
    assert cfg.segments(7777) == jcfg.segments(7777)


@pytest.mark.parametrize("cd", BAD_CD_VALUES, ids=str)
def test_bad_cd_values_rejected_like_jax(cd):
    with pytest.raises(ValueError):
        JaxConfig.from_cd_values(cd)
    with pytest.raises(ValueError):
        dt.RiceConfig.from_cd_values(cd)


def test_import_loads_neither_jax_nor_the_jax_package():
    probe = (
        "import sys, numpy as np, deltarice_tpu_torch as dt\n"
        "from deltarice_tpu_torch import cli, h5, optimize, utils\n"
        "from deltarice_tpu_torch.native import install\n"
        "from deltarice_tpu_torch import parallel\n"
        "from deltarice_tpu_torch.parallel import multihost, sharded\n"
        "import deltarice_tpu_torch.examples.sharded_encode\n"
        "import deltarice_tpu_torch.native.__main__\n"
        "x = np.arange(300, dtype=np.int16)\n"
        "cfg = dt.RiceConfig(8, 100)\n"
        "assert (dt.decompress(dt.compress(x, cfg, device='cpu'), cfg,"
        " device='cpu') == x).all()\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'deltarice_tpu', 'h5py')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_gather_into_a_given_array_equals_a_fresh_one():
    x = get_profile("nab").synthetic(6, seed=2, length=700)
    cfg = dt.RiceConfig(8, 700)
    buf = np.frombuffer(codec.compress(x, cfg, device="cpu"), dtype="<u4")
    counts, starts = codec.walk_headers(buf, 6)
    want = codec.gather_segments(buf, counts, starts, 512)
    out = np.zeros_like(want)
    assert codec.gather_segments(buf, counts, starts, 512, out=out) is out
    np.testing.assert_array_equal(out, want)
    with pytest.raises(ValueError, match="C-contiguous"):
        codec.gather_segments(buf, counts, starts, 512, out=out[:, :256])
