"""CPU tests of the benchmark's harness: cells found by their files, the
reference codec against the committed golden streams, the roofline's byte
arithmetic, the generator's ratios, the trace reduction, and the imports.

    python -m pytest benchmark/tests -q
"""

import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import run  # noqa: E402
from drbench import check, data, engine, reference, roofline, spec, trace  # noqa: E402

GOLDEN = ROOT / "tests" / "data" / "golden"
BENCHMARK = spec.load_benchmark()
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


#: lossless filters that no configuration of BENCHMARK.json states: the
#: optimizer's choice on Nab, a second difference, a negated delta, 9 taps
FILTERS = [(1, 0, -1), (1, -2, 1), (-1, 1), (1, -3, 2, 0, 1, -1, 4, 0, -2)]


def small(name: str, rows: int = 4, length: int = 2000,
          filt=None) -> spec.Cell:
    """A cell's own traffic and configuration at a size the CPU holds,
    with ``filt`` in place of the configuration's filter where given."""
    cell = spec.cell(name)
    cell.config = dict(cell.config, chunk_rows=rows, chunks_per_batch=1,
                       waveform_length=length)
    if filt is not None:
        cell.config["filter"] = list(filt)
    return cell


def _cell_found_by_its_files(name, bench=BENCHMARK, root=ROOT):
    cell = spec.cell(name, bench, root)
    assert cell.traffic["op"] in ("encode", "decode")
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "batch_p95_ms"}
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]))


def _contract_shape(bench=BENCHMARK, root=ROOT):
    cells = [w["name"] for w in bench["workloads"]]
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in bench["configs"]] + cells
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(cells)
    for c in bench["configs"]:
        assert (root / c["file"]).is_file()
        assert c["file"].startswith(bench["paths"][0] + "/")
    for w in bench["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_found_by_its_files(name):
    _cell_found_by_its_files(name)


def test_benchmark_json_keeps_the_contract_shape():
    _contract_shape()


def _golden_cases():
    return json.loads((GOLDEN / "manifest.json").read_text())


def _int32(v: int) -> int:
    return (int(v) + (1 << 31)) % (1 << 32) - (1 << 31)


@pytest.mark.parametrize("case", _golden_cases(), ids=lambda c: c["name"])
def test_reference_matches_golden(case):
    # cd_values: (M, L, n, *filter), each part optional, as the reference parses
    cd = case["cd_values"]
    m = cd[0] if cd else 8
    length = cd[1] if len(cd) > 1 else -1
    filt = (tuple(_int32(c) for c in cd[3:3 + cd[2]]) if len(cd) > 2
            else reference.DELTA)
    chunk = np.load(GOLDEN / f"{case['name']}.npy")
    assert reference.frame(chunk, m, length, filt) == (
        GOLDEN / f"{case['name']}.bin").read_bytes()


@pytest.mark.parametrize(
    "m,filt", [pytest.param(m, reference.DELTA, id=str(m)) for m in (1, 8, 64)]
    + [pytest.param(8, f, id=f"8-{f}") for f in FILTERS])
def test_reference_round_trips(m, filt):
    g = torch.Generator().manual_seed(m)
    x = torch.randint(-32768, 32768, (3, 300), generator=g).to(torch.int16)
    x[1] = torch.cumsum(torch.randint(-3, 4, (300,), generator=g), 0)
    x[2, :4] = -32768  # a negated tap wraps it
    nvalid = torch.full((3,), 300)
    nwords = reference.stream_words(x, nvalid, m, filt)
    words, counts = reference.encode(x, nvalid, m, int(nwords.max()) + 1, filt)
    assert torch.equal(counts, nwords)
    out = reference.decode(words.numpy().view(np.uint32), 300, m, filt)
    np.testing.assert_array_equal(out, x.numpy())


def test_reference_decode_refuses_a_lossy_filter():
    with pytest.raises(ValueError, match="no exact inverse"):
        reference.decode(np.zeros((1, 4), np.uint32), 8, 8, (2, -1))


def _walk(rows: int, length: int, seed: int) -> torch.Tensor:
    """Rows of small steps with rare large jumps, from numpy's generator."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.integers(-24, 25, (rows, length)), axis=1)
    x += np.where(rng.integers(0, 50, (rows, length)) == 0,
                  rng.integers(-4000, 4000, (rows, length)), 0)
    return torch.from_numpy(((x + 0x8000) & 0xFFFF) - 0x8000).to(torch.int16)


#: digests of the delta planes, counts and word cap that the reference
#: made before it took other filters: the four cells' work, byte for byte
DELTA_DIGESTS = {
    "nab": "c9156193271b112d061b7aaaa29d322fdd7792b13a90fd43c1d54a3a12ed76c7",
    "noptrex": "7133002fb28d99563711738a0e44a5d9125a58b016ba4f05bf8c197df70a1ebf",
}


@pytest.mark.parametrize("name,rows", [("nab", 16), ("noptrex", 2)])
def test_delta_planes_counts_and_cap_are_frozen(name, rows):
    conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    assert conf["filter"] == list(reference.DELTA)
    m, length = conf["rice_m"], conf["waveform_length"]
    x = _walk(rows, length, 2**31 + 41)
    nvalid = torch.full((rows,), length)
    nvalid[-1] = length - 3
    h = hashlib.sha256()
    words, counts = reference.encode_blocks(x, nvalid, m, conf["plane_words"])
    h.update(words.numpy().tobytes())
    h.update(counts.numpy().tobytes())
    h.update(reference.counts_blocks(x, nvalid, m).numpy().tobytes())
    h.update(str(engine.words_hint(x, m, length)).encode())
    assert h.hexdigest() == DELTA_DIGESTS[name]


def test_roofline_bytes_on_a_hand_made_case():
    # 3 rows of 10 samples, 7 stream words in all
    assert roofline.encode_bytes(3, 10, 7) == 60 + 28 + 12
    assert roofline.decode_bytes(3, 10, 7) == 28 + 60
    assert roofline.share_pct(3_350_000, 1e-6) == pytest.approx(100.0)
    assert roofline.share_pct(10, 0.0) is None


@pytest.mark.parametrize("name,rows,length", [("nab", 64, 7000),
                                              ("noptrex", 2, 500000)])
def test_generator_keeps_the_profile_ratio(name, rows, length):
    conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    x = data.synthetic(rows, length, conf["noise_sigma"], 2**31 + 11, "cpu")
    assert torch.equal(x, data.synthetic(rows, length, conf["noise_sigma"],
                                         2**31 + 11, "cpu"))
    counts = reference.counts_blocks(x, torch.full((rows,), length), conf["rice_m"])
    assert data.ratio(counts, rows, length) == pytest.approx(
        conf["published_ratio"], abs=0.01)


def _codeword_cap(x, m, length, filt):
    """The encode's word cap from the reference's code lengths: the largest
    rate of 64 rows' first 4096 filtered samples + 20 % + 64 words, in
    buckets of 256, never above the worst case."""
    sub = x[:: max(1, x.shape[0] // 64)][:64][:, :4096]
    bits, _ = reference.codewords(sub, torch.full((sub.shape[0],), sub.shape[1]),
                                  m, filt)
    est = float(bits.to(torch.float64).mean(dim=1).max()) * 1.2 * length / 32 + 64
    cap = -(-int(est) // engine.WORD_BUCKET) * engine.WORD_BUCKET
    return min(cap, reference.max_words(length, m))


def _words_hint_of_each_config(bench=BENCHMARK, root=ROOT):
    """A delta configuration's cap is the program's own; the program takes
    the worst case for any other filter, so there the cap is the codeword
    arithmetic on the reference-filtered subsample."""
    from deltarice_tpu_torch import RiceConfig
    from deltarice_tpu_torch.codec import _words_hint

    for c in bench["configs"]:
        conf = json.loads((root / c["file"]).read_text())
        m, length = conf["rice_m"], conf["waveform_length"]
        filt = tuple(conf["filter"])
        x = data.synthetic(200, min(length, 7000), conf["noise_sigma"], 5, "cpu")
        cap = engine.words_hint(x, m, length, filt=filt)
        assert cap <= reference.max_words(length, m)
        if filt == reference.DELTA:
            assert cap == _words_hint(x.numpy(), RiceConfig(m, length), length)
        else:
            assert cap == _codeword_cap(x, m, length, filt)


def test_words_hint_is_the_programs():
    from deltarice_tpu_torch import RiceConfig
    from deltarice_tpu_torch.codec import _words_hint

    x = data.synthetic(200, 7000, 5.45, 5, "cpu")
    assert engine.words_hint(x, 8, 7000) == _words_hint(
        x.numpy(), RiceConfig(8, 7000), 7000)
    _words_hint_of_each_config()
    for m in (1, 8, 16, 8192, 32768):
        assert reference.max_words(500000, m) == RiceConfig(m).max_words(500000)


@pytest.mark.parametrize("filt", FILTERS[:2], ids=str)
def test_words_hint_follows_the_filter(filt):
    x = data.synthetic(128, 7000, 5.45, 2**31 + 19, "cpu")
    cap = engine.words_hint(x, 8, 7000, filt=filt)
    assert cap == _codeword_cap(x, 8, 7000, filt)
    assert cap < reference.max_words(7000, 8)


def test_a_generic_filter_configuration_added_as_data_passes(tmp_path):
    # a deployment added beside the real ones by data files alone, as a
    # later configuration would be: every loop over the configurations
    # and cells takes it unedited
    (tmp_path / "benchmark" / "configs").mkdir(parents=True)
    for c in BENCHMARK["configs"]:
        (tmp_path / c["file"]).write_text((ROOT / c["file"]).read_text())
    nab = json.loads((BENCH / "configs" / "nab.json").read_text())
    conf = dict(nab, name="nab_generic", filter=[1, 0, -1])
    (tmp_path / "benchmark" / "configs" / "nab_generic.json").write_text(
        json.dumps(conf))
    bench = json.loads(json.dumps(BENCHMARK))
    bench["configs"].append(dict(bench["configs"][0], name="nab_generic",
                                 file="benchmark/configs/nab_generic.json"))
    twins = {w["name"]: f"nab_generic.{w['traffic']}"
             for w in BENCHMARK["workloads"] if w["config"] == "nab"}
    bench["workloads"] += [dict(w, name=twins[w["name"]], config="nab_generic")
                           for w in BENCHMARK["workloads"] if w["name"] in twins]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:  # each new cell reports what its nab twin does
            m["workloads"] += [twins[n] for n in m["workloads"] if n in twins]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    bench = spec.load_benchmark(tmp_path)
    _contract_shape(bench, tmp_path)
    for w in bench["workloads"]:
        _cell_found_by_its_files(w["name"], bench, tmp_path)
    _words_hint_of_each_config(bench, tmp_path)


def test_trace_union_and_gaps():
    host = [("bench.window", 0, 100), ("bench.issue", 0, 10),
            ("bench.wait", 60, 95)]
    device = [("k1", 10, 30), ("Memcpy DtoH", 25, 40), ("k2", 70, 90),
              ("k0", -20, 5)]
    s = trace.summarize(device, host)
    assert s.window_s == pytest.approx(100e-9)
    assert s.busy_s == pytest.approx(55e-9)  # [0,5) + [10,40) + [70,90)
    assert s.kernel_s == pytest.approx(45e-9)  # copies left out
    # gaps [40, 70), [90, 100), [5, 10), each named by the span over it most
    assert [(n, round(t * 1e9)) for n, t in s.gaps] == [
        ("wait", 30), ("wait", 10), ("issue", 5)]
    assert trace.summarize(device, []) is None


@pytest.mark.parametrize("name", CELLS)
def test_a_small_run_is_correct_on_the_cpu(name):
    import deltarice_tpu_torch as program

    length = 2000 if name.endswith("encode") else 600
    res = run.run(small(name, length=length), 2**31 + 3, 0.2, False, "cpu",
                  program, 0.0)
    assert res["correct"] and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in spec.cell(name).end_to_end}


@pytest.mark.parametrize("filt", FILTERS[:2], ids=str)
@pytest.mark.parametrize("name", ["nab.vram_encode", "nab.vram_decode"])
def test_a_generic_filter_runs_correct_on_the_cpu(name, filt):
    import deltarice_tpu_torch as program

    length = 2000 if name.endswith("encode") else 600
    cell = small(name, length=length, filt=filt)
    res = run.run(cell, 2**31 + 23, 0.2, False, "cpu", program, 0.0)
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["calls_checked"]["value"] >= 1


@pytest.mark.parametrize("name", ["nab.vram_encode", "nab.vram_decode"])
def test_a_lossy_filter_is_refused_at_set_up(name):
    import deltarice_tpu_torch as program

    cell = small(name, length=600, filt=(2, -1))
    with pytest.raises(ValueError, match="lossy"):
        engine.Workload(program, cell.config, cell.traffic, 2**31 + 29, "cpu")


@pytest.mark.parametrize("name", [c for c in CELLS if c.endswith("encode")])
def test_rows_past_the_cap_are_encoded_again_and_checked(name, monkeypatch):
    import deltarice_tpu_torch as program

    monkeypatch.setattr(engine, "words_hint",
                        lambda x, m, length, filt=None: 256)
    res = run.run(small(name), 2**31 + 7, 0.2, False, "cpu", program, 0.0)
    assert res["correct"] and res["checks"]["calls_checked"]["value"] >= 1


@pytest.mark.parametrize("name", [c for c in CELLS if c.endswith("decode")])
def test_a_plane_too_narrow_for_a_stream_is_refused(name):
    import deltarice_tpu_torch as program

    cell = small(name, length=600)
    with pytest.raises(ValueError, match="no pad word"):
        engine.Workload(program, dict(cell.config, plane_words=8),
                        cell.traffic, 2**31 + 17, "cpu")


class GarbagePastTheCount:
    """The program, with every word past each row's count overwritten: no
    part of any stream, so not the check's to judge."""

    def __init__(self, program):
        self.prog = program
        self.RiceConfig = program.RiceConfig

    def encode_segments(self, x, nvalid, cfg, max_words, device="cuda"):
        words, counts = self.prog.encode_segments(x, nvalid, cfg, max_words,
                                                  device=device)
        words = words.clone()
        col = torch.arange(words.shape[1], device=words.device)[None, :]
        words[col >= counts.to(torch.int64)[:, None]] = 0x5A5A5A5A
        return words, counts


@pytest.mark.parametrize("name", [c for c in CELLS if c.endswith("encode")])
def test_words_past_a_rows_count_are_not_judged(name):
    import deltarice_tpu_torch as program

    res = run.run(small(name), 2**31 + 13, 0.2, False, "cpu",
                  GarbagePastTheCount(program), 0.0)
    assert res["correct"] and res["checks"]["calls_checked"]["value"] >= 1


def test_rows_wrong_judges_every_word_below_the_count():
    ref = torch.tensor([[7, 8, 0, 0], [5, 0, 0, 0]], dtype=torch.int32)
    counts = torch.tensor([2, 1])
    got = ref.clone()
    got[:, 2:] = -1  # past both counts
    assert check.encode_rows_wrong((got, counts.to(torch.int32)), ref, counts) == 0
    got[0, 1] ^= 1  # the last word's zero-filled low bit, inside the count
    assert check.encode_rows_wrong((got, counts.to(torch.int32)), ref, counts) == 1
    assert check.encode_rows_wrong(
        (got[:, :1], counts.to(torch.int32)), ref, counts) == 1  # too narrow
    assert check.encode_rows_wrong(
        (ref, torch.tensor([2, 2], dtype=torch.int32)), ref, counts) == 1


@pytest.mark.parametrize("name", [c for c in CELLS if c.endswith("encode")])
def test_a_traced_run_prints_only_what_it_read(name):
    import deltarice_tpu_torch as program

    res = run.run(small(name), 2**31 + 5, 0.2, True, "cpu", program, 0.0)
    per_layer = {m["name"] for m in spec.cell(name).per_layer}
    assert res["correct"] and set(res["metrics"]) <= per_layer
    assert "enqueue_ms.encode" in res["metrics"]
    assert "busy_s" not in res["device"]  # no device trace on the CPU


def test_no_jax_and_a_reference_free_of_the_program():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from drbench import reference, data, check, engine, trace, roofline, spec\n"
        "import control\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'deltarice_tpu_torch' not in tops, 'reference loads the program'\n"
        "import run, deltarice_tpu_torch\n"
        "print(run.forbidden_loaded())\n" % (str(BENCH), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "deltarice_tpu")


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "deltarice_tpu_torch.x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "deltarice_tpu.codec", sys)
    assert run.forbidden_loaded() == ["deltarice_tpu", "jax"]


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          CELLS[0], "--seed", str(2**31 + 9), "--seconds", "2",
                          "--trace", "1"], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["busy_s"] > 0
