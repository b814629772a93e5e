"""The port's chunk data parallelism (``deltarice_tpu_torch.parallel``)
against ``deltarice_tpu.parallel`` on the CPU.

The same numpy inputs, made from a seed, go through the JAX functions on an
8-device CPU mesh (as ``tests/test_parallel.py`` runs them) and through the
port's with ``device="cpu"`` (the kernels' plain versions). Everything is
integer: equality is exact. The two-rank run goes through
``python -m deltarice_tpu_torch.examples.sharded_encode`` on gloo with a
``file://`` store, so it needs no rendezvous port.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import deltarice_tpu as drt
from deltarice_tpu.codec import frame_stream as jax_frame_stream
from deltarice_tpu.config import RiceConfig as JaxConfig
from deltarice_tpu.parallel import chunk_mesh as jax_chunk_mesh
from deltarice_tpu.parallel import decode_chunks_sharded as jax_decode
from deltarice_tpu.parallel import encode_chunks_sharded as jax_encode
from deltarice_tpu.parallel import roundtrip_check_step as jax_roundtrip
from deltarice_tpu.parallel import multihost as jax_multihost
from deltarice_tpu.parallel.sharded import put_sharded as jax_put
import deltarice_tpu_torch as dt
from deltarice_tpu_torch.codec import frame_stream
from deltarice_tpu_torch.native import native_compress, native_decompress
from deltarice_tpu_torch.parallel import (
    chunk_mesh,
    decode_chunks_sharded,
    encode_chunks_sharded,
    roundtrip_check_step,
)
from deltarice_tpu_torch.parallel import multihost
from deltarice_tpu_torch.parallel.sharded import ChunkMesh, put_sharded

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
LAUNCH_ENV = ("WORLD_SIZE", "MASTER_ADDR", "SLURM_JOB_ID", "SLURM_NTASKS",
              "SLURM_PROCID", "LOCAL_RANK")
# (nchunks, nseg, L), M, filter, seed, short last segment
CASES = {
    "8x3x200-m8": ((8, 3, 200), 8, (1, -1), 7, None),
    "16x2x128-m4": ((16, 2, 128), 4, (1, -1), 3, None),
    "short-leftover": ((8, 4, 256), 8, (1, -1), 0, 100),
    "fir2": ((8, 3, 200), 8, (1, -2, 1), 5, None),
}


def _jax_mesh(n=8):
    devs = jax.devices("cpu")
    if len(devs) < n:
        pytest.skip(f"need {n} cpu devices, have {len(devs)}")
    return jax_chunk_mesh(devs[:n])


def _walk(shape, seed, sigma=10.0):
    """Random-walk int16 waveforms; a large ``sigma`` wraps through the
    whole int16 range."""
    rng = np.random.default_rng(seed)
    return np.round(np.cumsum(rng.normal(0, sigma, shape), axis=-1)
                    ).astype(np.int64).astype(np.int16)


def _case(name):
    shape, m, filt, seed, short = CASES[name]
    x = _walk(shape, seed)
    nvalid = np.full(shape[:2], shape[2], dtype=np.int32)
    if short is not None:
        nvalid[-1, -1] = short
    return (x, nvalid, dt.RiceConfig(m, shape[2], filt),
            JaxConfig(m, shape[2], filt))


def _valid(nwords, width):
    return np.arange(width)[None, None, :] < np.asarray(nwords)[..., None]


@pytest.fixture
def no_launch_env(monkeypatch):
    for var in LAUNCH_ENV:
        monkeypatch.delenv(var, raising=False)


@pytest.fixture
def gloo_world_of_one(tmp_path, no_launch_env):
    """A one-rank gloo process group in this process, torn down after."""
    multihost.initialize_distributed(
        device="cpu", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1)
    try:
        yield chunk_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


# --- (a) encode ----------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CASES))
def test_encode_matches_jax(name):
    x, nvalid, cfg, jcfg = _case(name)
    length = x.shape[2]
    width = cfg.max_words(length)
    jmesh = _jax_mesh()
    jw, jn = jax_encode(jax_put(x, jmesh), jax_put(nvalid, jmesh), jcfg,
                        jmesh, width)
    jw, jn = np.asarray(jw).view(np.uint32), np.asarray(jn)
    tw, tn = encode_chunks_sharded(x, nvalid, cfg, chunk_mesh(device="cpu"),
                                   width)
    tw, tn = tw.numpy().view(np.uint32), tn.numpy()
    assert tw.shape == jw.shape
    np.testing.assert_array_equal(tn, jn)
    valid = _valid(tn, width)
    np.testing.assert_array_equal(np.where(valid, tw, 0),
                                  np.where(valid, jw, 0))
    for c in range(x.shape[0]):
        total = int(nvalid[c].sum())
        blob = frame_stream(total, tw[c], tn[c])
        assert blob == jax_frame_stream(total, jw[c], jn[c])
        assert blob == drt.compress(x[c].ravel()[:total], jcfg)


# --- (b) decode ----------------------------------------------------------


@pytest.mark.parametrize("j_eff", [None, 3])
@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_matches_jax_and_the_input(name, j_eff):
    x, nvalid, cfg, jcfg = _case(name)
    length = x.shape[2]
    mesh = chunk_mesh(device="cpu")
    words, _nw = encode_chunks_sharded(x, nvalid, cfg, mesh,
                                       cfg.max_words(length))
    words = words.numpy().view(np.uint32)
    jmesh = _jax_mesh()
    jres = jax_decode(jax_put(words, jmesh), length, jcfg, jmesh,
                      j_eff=j_eff)
    tres = decode_chunks_sharded(words, length, cfg, mesh, j_eff=j_eff)
    if j_eff is None:
        jout, tout = np.asarray(jres), tres.numpy()
    else:
        jout, tout = np.asarray(jres[0]), tres[0].numpy()
        assert not np.asarray(jres[1]).any()
        assert tres[1].shape == x.shape[:2] and not tres[1].any()
    valid = np.arange(length)[None, None, :] < nvalid[..., None]
    np.testing.assert_array_equal(np.where(valid, tout, 0),
                                  np.where(valid, jout, 0))
    np.testing.assert_array_equal(np.where(valid, tout, 0),
                                  np.where(valid, x, 0))


def test_decode_pads_a_full_width_row():
    """A stream that fills every word of its row still decodes: B2 gets a
    zero pad word appended."""
    rng = np.random.default_rng(11)
    x = rng.integers(-32768, 32768, (1, 2, 64)).astype(np.int16)
    cfg = dt.RiceConfig(1, 64)
    mesh = chunk_mesh(device="cpu")
    nvalid = np.full((1, 2), 64, np.int32)
    words, nwords = encode_chunks_sharded(x, nvalid, cfg, mesh,
                                          cfg.max_words(64))
    assert int(nwords.max()) == cfg.max_words(64)
    out = decode_chunks_sharded(words, 64, cfg, mesh)
    np.testing.assert_array_equal(out.numpy(), x)


# --- (c) the round-trip check step ---------------------------------------


def test_roundtrip_lossless_has_no_mismatch():
    x, nvalid, cfg, jcfg = _case("short-leftover")
    width = cfg.max_words(x.shape[2])
    jmesh = _jax_mesh()
    *_, jbad = jax_roundtrip(jax_put(x, jmesh), jax_put(nvalid, jmesh), jcfg,
                             jmesh, width)
    words, nwords, bad = roundtrip_check_step(x, nvalid, cfg,
                                              chunk_mesh(device="cpu"), width)
    assert int(jbad) == 0 and bad == 0
    assert tuple(words.shape) == (*x.shape[:2], width)
    assert tuple(nwords.shape) == x.shape[:2]


def _native_mismatches(x, nvalid, cfg) -> int:
    """Valid samples that the native C codec's round trip does not give
    back: the reference count for a lossy filter. Only each chunk's last
    segment may be short (or the whole chunk empty)."""
    cd = cfg.to_cd_values()
    bad = 0
    for c in range(x.shape[0]):
        total = int(nvalid[c].sum())
        if total:
            want = x[c].ravel()[:total]
            bad += int((native_decompress(native_compress(want, cd), cd)
                        != want).sum())
    return bad


@pytest.mark.parametrize("filt", [(2, -1), (2, 1, -1)])
def test_roundtrip_lossy_counts_like_the_reference(filt):
    """filt[0] = 2 is lossy where 2x wraps int16 (``lossless`` is false):
    the port counts the mismatches of the native C round trip, and so does
    JAX's psum over 8 devices once each row has a zero pad word (at width
    ``max_words`` JAX's sharded decode misreads a stream that fills its
    row)."""
    x = _walk((8, 2, 192), 21, sigma=1000.0)
    nvalid = np.full((8, 2), 192, np.int32)
    nvalid[3, 1] = 50
    cfg, jcfg = dt.RiceConfig(8, 192, filt), JaxConfig(8, 192, filt)
    assert not cfg.lossless
    want = _native_mismatches(x, nvalid, cfg)
    assert want > 0
    mesh = chunk_mesh(device="cpu")
    width = cfg.max_words(192)
    assert roundtrip_check_step(x, nvalid, cfg, mesh, width)[2] == want
    jmesh = _jax_mesh()
    *_, jbad = jax_roundtrip(jax_put(x, jmesh), jax_put(nvalid, jmesh), jcfg,
                             jmesh, width + 1)
    assert roundtrip_check_step(x, nvalid, cfg, mesh, width + 1)[2] == \
        int(jbad) == want


def test_full_width_rows_round_trip_exactly():
    """Escape-heavy streams fill their max_words rows: the port's step
    still finds no mismatch (JAX's sharded decode, with no pad word,
    finds some)."""
    rng = np.random.default_rng(21)
    x = rng.integers(-32768, 32768, (8, 2, 192)).astype(np.int16)
    nvalid = np.full((8, 2), 192, np.int32)
    cfg = dt.RiceConfig(8, 192)
    words, nwords, bad = roundtrip_check_step(
        x, nvalid, cfg, chunk_mesh(device="cpu"), cfg.max_words(192))
    assert int(nwords.max()) == cfg.max_words(192) and bad == 0
    jmesh = _jax_mesh()
    *_, jbad = jax_roundtrip(jax_put(x, jmesh), jax_put(nvalid, jmesh),
                             JaxConfig(8, 192), jmesh, cfg.max_words(192))
    assert int(jbad) > 0


def test_a_world_of_one_sums_through_the_group(gloo_world_of_one):
    """With a process group up the mesh is a DeviceMesh over it and every
    result passes through the collectives; one rank gives the meshless
    results."""
    mesh = gloo_world_of_one
    assert mesh.group is not None and mesh.size == 1 and mesh.rank == 0
    assert mesh.group.size() == 1 and mesh.comm == CPU
    x = _walk((3, 2, 192), 21, sigma=1000.0)
    nvalid = np.full((3, 2), 192, np.int32)
    cfg = dt.RiceConfig(8, 192, (2, -1))
    *_, bad = roundtrip_check_step(x, nvalid, cfg, mesh, cfg.max_words(192))
    *_, want = roundtrip_check_step(x, nvalid, cfg, ChunkMesh(CPU),
                                    cfg.max_words(192))
    assert bad == want > 0
    lossless = dt.RiceConfig(8, 192)
    streams = multihost.encode_chunks_multihost(x, lossless, mesh)
    assert streams == multihost.encode_chunks_multihost(x, lossless,
                                                        ChunkMesh(CPU))
    assert streams == dt.compress_batch(list(x), lossless, device="cpu")
    back = multihost.decode_chunks_multihost(streams, lossless, mesh)
    np.testing.assert_array_equal(back, x.reshape(3, -1))


# --- put_sharded and the one-rank multihost path --------------------------


def test_put_sharded_takes_the_ranks_block():
    x = np.arange(6 * 2 * 3, dtype=np.int16).reshape(6, 2, 3)
    got = put_sharded(x, ChunkMesh(CPU, rank=1, size=3))
    np.testing.assert_array_equal(got.numpy(), x[2:4])
    words = np.full((4, 1, 2), 0xFFFFFFFF, dtype=np.uint32)
    got = put_sharded(words, ChunkMesh(CPU, rank=0, size=2))
    assert got.dtype == torch.int32 and bool((got == -1).all())
    with pytest.raises(ValueError, match="divide"):
        put_sharded(x, ChunkMesh(CPU, rank=0, size=4))


@pytest.mark.parametrize("nchunks", [0, 5])
def test_one_rank_multihost_matches_jax(nchunks):
    x = _walk((nchunks, 4, 300), 13)
    cfg, jcfg = dt.RiceConfig(8, 300), JaxConfig(8, 300)
    jmesh = _jax_mesh()
    mesh = chunk_mesh(device="cpu")
    streams = multihost.encode_chunks_multihost(x, cfg, mesh)
    assert streams == jax_multihost.encode_chunks_multihost(x, jcfg, jmesh)
    back = multihost.decode_chunks_multihost(streams, cfg, mesh)
    want = jax_multihost.decode_chunks_multihost(streams, jcfg, jmesh)
    assert back.dtype == want.dtype == np.int16
    np.testing.assert_array_equal(back, want)
    if nchunks:
        np.testing.assert_array_equal(back, x.reshape(nchunks, -1))


# --- (d) two ranks over gloo through the example ---------------------------


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One run of the example: 7 and 6 chunks of (8, 256) over two gloo
    ranks, round-trip check with the lossy filter (2, -1). Returns (the
    batch, its directory, each rank's report)."""
    out = tmp_path_factory.mktemp("two_ranks")
    x = _walk((7, 8, 256), 17, sigma=1000.0)
    np.save(out / "x.npy", x)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    for var in LAUNCH_ENV:
        env.pop(var, None)
    res = subprocess.run(
        [sys.executable, "-m", "deltarice_tpu_torch.examples.sharded_encode",
         "--world", "2", "--backend", "gloo", "--device", "cpu", "--out",
         str(out), "--input", str(out / "x.npy"), "--chunks", "7,6",
         "--check-filter", "2,-1"],
        capture_output=True, text=True, timeout=150, cwd=ROOT, env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    reports = [json.loads((out / f"rank{r}.json").read_text())
               for r in range(2)]
    return x, out, reports


def _streams(out, report, n):
    blob = (out / f"streams_{n}.bin").read_bytes()
    ends = np.cumsum(report["chunks"][str(n)]["streams"])
    return [blob[a:b] for a, b in zip(np.r_[0, ends[:-1]], ends)]


@pytest.mark.parametrize("n", [6, 7])
def test_two_ranks_streams_equal_jax(two_ranks, n):
    x, out, reports = two_ranks
    jcfg = JaxConfig(8, 256)
    streams = _streams(out, reports[0], n)
    assert len(streams) == n
    for c in range(n):
        assert streams[c] == drt.compress(x[c].ravel(), jcfg)
    assert streams == jax_multihost.encode_chunks_multihost(x[:n], jcfg,
                                                            _jax_mesh())


@pytest.mark.parametrize("n", [6, 7])
def test_two_ranks_decode_equals_the_input(two_ranks, n):
    x, out, reports = two_ranks
    np.testing.assert_array_equal(np.load(out / f"decoded_{n}.npy"),
                                  x[:n].reshape(n, -1))
    assert reports[0]["chunks"][str(n)]["decoded"]


def test_rank_one_gets_none_and_no_rank_loads_jax(two_ranks):
    _x, _out, reports = two_ranks
    for n in ("6", "7"):
        assert reports[1]["chunks"][n]["streams"] is None
        assert not reports[1]["chunks"][n]["decoded"]
    assert [r["rank"] for r in reports] == [0, 1]
    assert all(r["world"] == 2 and r["jax_loaded"] == [] for r in reports)


@pytest.mark.parametrize("n", [6, 7])
def test_two_ranks_sum_the_lossy_mismatches(two_ranks, n):
    """The all-reduce gives every rank the whole batch's count: the native
    C round trip's, and JAX's psum over the batch padded to 8 chunks with
    empty ones (with a pad word per row, see above)."""
    x, _out, reports = two_ranks
    xp = np.concatenate([x[:n], np.zeros((8 - n, 8, 256), np.int16)])
    nvalid = np.zeros((8, 8), np.int32)
    nvalid[:n] = 256
    jcfg = JaxConfig(8, 256, (2, -1))
    jmesh = _jax_mesh()
    *_, jbad = jax_roundtrip(jax_put(xp, jmesh), jax_put(nvalid, jmesh),
                             jcfg, jmesh, jcfg.max_words(256) + 1)
    want = _native_mismatches(xp, nvalid, dt.RiceConfig(8, 256, (2, -1)))
    counts = [r["chunks"][str(n)]["mismatches"] for r in reports]
    assert counts == [want] * 2 and int(jbad) == want > 0


# --- (e) decode_chunks_multihost's checks ----------------------------------


def _jax_and_port_decode(streams):
    jcfg, cfg = JaxConfig(8, 64), dt.RiceConfig(8, 64)
    out = []
    for fn, c, m in ((jax_multihost.decode_chunks_multihost, jcfg,
                      _jax_mesh()),
                     (multihost.decode_chunks_multihost, cfg,
                      chunk_mesh(device="cpu"))):
        try:
            out.append(fn(streams, c, m))
        except ValueError as e:
            out.append(e)
    return out


def test_decode_multihost_of_no_streams_is_empty():
    jout, tout = _jax_and_port_decode([])
    assert jout.shape == tout.shape == (0, 0)
    assert jout.dtype == tout.dtype == np.int16


@pytest.mark.parametrize("case", ["zero-length", "cut", "unequal"])
def test_decode_multihost_rejects_like_jax(case):
    x = _walk((3, 2, 64), 9)
    streams = dt.compress_batch(list(x), dt.RiceConfig(8, 64), device="cpu")
    if case == "zero-length":
        streams[1] = b""
    elif case == "cut":
        streams[2] = streams[2][:len(streams[2]) // 2]
    else:
        streams[1] = dt.compress(x[1, :1], dt.RiceConfig(8, 64),
                                 device="cpu")
    jout, tout = _jax_and_port_decode(streams)
    assert isinstance(jout, ValueError) and isinstance(tout, ValueError)
    if case != "unequal":
        assert "truncated" in str(tout)


# --- (f) initialize_distributed --------------------------------------------


def test_initialize_without_a_launch_is_a_no_op(no_launch_env, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "1")
    multihost.initialize_distributed()
    assert not dist.is_initialized()


def test_initialize_with_a_bad_backend_raises(tmp_path, no_launch_env):
    with pytest.raises((AssertionError, RuntimeError, ValueError)):
        multihost.initialize_distributed(
            device="cpu", backend="no-such-backend",
            init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    assert not dist.is_initialized()


@pytest.mark.parametrize("launch", ["torchrun", "slurm"])
def test_initialize_reads_the_launch_environment(no_launch_env, monkeypatch,
                                                 launch):
    if launch == "torchrun":
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("MASTER_ADDR", "localhost")
        want = {"init_method": "env://", "backend": "gloo"}
    else:
        monkeypatch.setenv("SLURM_JOB_ID", "7")
        monkeypatch.setenv("SLURM_NTASKS", "4")
        monkeypatch.setenv("SLURM_PROCID", "2")
        want = {"init_method": "env://", "rank": 2, "world_size": 4,
                "backend": "gloo"}
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    multihost.initialize_distributed(device="cpu")
    assert calls == [want]


def test_initialize_is_idempotent(no_launch_env, monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: pytest.fail("initialised twice"))
    multihost.initialize_distributed(device="cpu", init_method="env://")


# --- (g) no card ------------------------------------------------------------


def test_a_cuda_device_without_a_card_raises(no_launch_env, monkeypatch,
                                             tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ("cuda", "cuda:0", None):
        with pytest.raises(RuntimeError, match="CUDA card"):
            chunk_mesh(device=device)
    with pytest.raises(RuntimeError, match="CUDA card"):
        multihost.initialize_distributed(
            init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    assert not dist.is_initialized()
