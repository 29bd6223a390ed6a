"""The slice as a whole: repro_torch's CompressedStringStore on the CPU
answers multiget byte-identically to the JAX package's store (jax and numpy
backends), whether it trains and encodes itself or serves the reference's
tables and corpus through ``repro_torch.convert``."""

import numpy as np
import pytest
import torch

from repro.core import make_onpair16
from repro.data.synth import load_dataset as ref_load_dataset
from repro.obs.metrics import merge_hist_states
from repro.store import CompressedStringStore as RefStore
from repro_torch import convert
from repro_torch.core.codec import Decoder, Encoder
from repro_torch.core.packed import PackedDictionary
from repro_torch.data.synth import load_dataset
from repro_torch.kernels import ops, ref
from repro_torch.obs import REGISTRY, TRACER
from repro_torch.store import CompressedStringStore

SAMPLE = 1 << 19
SEG = 1024


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are tiny: torch's intra-op threads would only
    contend with XLA's thread pool in the same process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def titles():
    # hand-placed edge strings inside a real corpus, as the reference tests do
    strings = load_dataset("book_titles", SAMPLE)
    assert strings == ref_load_dataset("book_titles", SAMPLE)
    strings[3] = b""
    strings[100] = b""
    strings[7] = b"\x00\xff" * 9
    strings[11] = bytes(range(256))
    return strings


@pytest.fixture(scope="module")
def ref_comp(titles):
    comp = make_onpair16(sample_bytes=SAMPLE, seed=7)
    comp.train(titles)
    return comp, comp.compress(titles)


@pytest.fixture(scope="module")
def ref_stores(ref_comp):
    comp, corpus = ref_comp
    return {backend: RefStore(comp, corpus, backend=backend,
                              strings_per_segment=SEG)
            for backend in ("jax", "numpy")}


@pytest.fixture(scope="module")
def port_store(titles):
    return CompressedStringStore.build(titles, sample_bytes=SAMPLE, seed=7,
                                       device="cpu", strings_per_segment=SEG)


@pytest.fixture(scope="module")
def converted_store(ref_comp):
    """The reference's dictionary tables and corpus, served by the port."""
    comp, corpus = ref_comp
    d = comp.dictionary
    dd = convert.dictionary_from_reference(
        {k: getattr(d, k) for k in ref.ARRAY_FIELDS}, d.s_probe_max,
        d.p_probe_max, max(1, d.max_bucket_size), device="cpu")
    port_corpus = convert.corpus_from_reference(corpus.payload, corpus.offsets,
                                                corpus.raw_bytes)
    return CompressedStringStore(dd, port_corpus, device="cpu",
                                 strings_per_segment=SEG, cache_bytes=0)


def _ids(n, seed, size=700):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, size).tolist()
    return ids + ids[:50] + [0, 3, 7, 11, 100, n - 1]  # duplicates + edges


def test_port_build_encodes_like_reference(port_store, ref_comp):
    _, corpus = ref_comp
    np.testing.assert_array_equal(port_store.corpus.payload, corpus.payload)
    np.testing.assert_array_equal(port_store.corpus.offsets, corpus.offsets)
    assert port_store.corpus.ratio == corpus.ratio


@pytest.mark.parametrize("backend", ["jax", "numpy"])
@pytest.mark.parametrize("which", ["built", "converted"])
def test_multiget_matches_reference_store(port_store, converted_store,
                                          ref_stores, titles, backend, which):
    store = port_store if which == "built" else converted_store
    ids = _ids(len(titles), 42)
    got = store.multiget(ids)
    assert got == ref_stores[backend].multiget(ids)
    assert got == [titles[i] for i in ids]


def test_bucket_caps_match_reference(port_store, converted_store, ref_stores):
    for store in (port_store, converted_store):
        np.testing.assert_array_equal(store.bucket_caps,
                                      ref_stores["numpy"].bucket_caps)


def test_every_string_round_trips(converted_store, titles):
    assert converted_store.multiget(range(len(titles))) == titles


@pytest.mark.parametrize("cache_bytes", [0, 1 << 12, 8 << 20])
def test_multiget_cache_on_and_off(ref_comp, ref_stores, titles, cache_bytes):
    comp, corpus = ref_comp
    store = CompressedStringStore(PackedDictionary.build(comp.dictionary.entries),
                                  corpus, device="cpu", strings_per_segment=SEG,
                                  cache_bytes=cache_bytes)
    for seed in (1, 2):  # the second pass hits a warm cache where it is on
        ids = _ids(len(titles), seed, size=300)
        assert store.multiget(ids) == ref_stores["numpy"].multiget(ids)
    cache = store.stats_snapshot()["cache"]
    assert (cache["hits"] > 0) == (cache_bytes > 0)
    assert cache["bytes"] <= max(cache_bytes, 0)


def test_multiget_order_duplicates_and_single_gets(port_store, titles):
    ids = [9, 9, 12, 9, 3, 12, 3, 11]
    before = port_store.stats.decoded_strings
    assert port_store.multiget(ids) == [titles[i] for i in ids]
    assert port_store.stats.decoded_strings - before <= 4
    assert port_store.multiget([]) == []
    assert port_store.get(11) == bytes(range(256))
    assert len(port_store) == port_store.n_strings == len(titles)


@pytest.mark.parametrize("bad", [-1, "n", "n+5"])
def test_multiget_rejects_out_of_range_before_any_work(port_store, titles, bad):
    n = len(titles)
    i = {"n": n, "n+5": n + 5}.get(bad, bad)
    before = (port_store.stats.batches, port_store.stats.lookups)
    with pytest.raises(IndexError):
        port_store.multiget([0, 1, i])
    assert (port_store.stats.batches, port_store.stats.lookups) == before


def test_long_strings_grow_the_top_bucket(ref_comp):
    """A string longer than every bucket mints a geometric top bucket."""
    comp, _ = ref_comp
    d = PackedDictionary.build(comp.dictionary.entries)
    strings = [b"abc", b"de", bytes(range(256)) * 2]
    corpus = Encoder(d, device="cpu").encode(strings)
    store = CompressedStringStore(d, corpus, device="cpu", num_buckets=1)
    top = int(store.bucket_caps[-1])
    store.bucket_caps = store.bucket_caps[:1] // 4  # as if built on short data
    assert store.multiget([2, 0, 1]) == [strings[2], strings[0], strings[1]]
    assert int(store.bucket_caps[-1]) >= top


def test_stats_snapshot_and_decode_counter(port_store, titles):
    before = ops._DECODE_BATCHES["ref"].value
    port_store.multiget(_ids(len(titles), 9, size=100))
    snap = port_store.stats_snapshot()
    assert snap["backend"] == "cpu" and snap["n_strings"] == len(titles)
    assert snap["n_segments"] == -(-len(titles) // SEG)
    assert all(shape[0] == 256 for shape in snap["jit_shapes"])
    assert snap["memory_bytes"] > port_store.corpus.compressed_bytes
    assert ops._DECODE_BATCHES["ref"].value > before


def test_decoder_access_matches_reference(ref_comp, titles):
    comp, corpus = ref_comp
    dec = Decoder(PackedDictionary.build(comp.dictionary.entries), device="cpu")
    for i in (0, 3, 7, 11, len(titles) - 1):
        assert dec.access(corpus, i) == comp.access(corpus, i) == titles[i]


def test_convert_rejects_malformed_corpus(ref_comp):
    _, corpus = ref_comp
    with pytest.raises(ValueError):
        convert.corpus_from_reference(corpus.payload, corpus.offsets[:-1] + 1,
                                      corpus.raw_bytes)


def test_default_device_is_cuda_and_raises_without_it(monkeypatch, ref_comp,
                                                      titles):
    """Entry points default to the card; with no CUDA they raise instead of
    running on the host, unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    comp, corpus = ref_comp
    d = PackedDictionary.build(comp.dictionary.entries)
    for make in (lambda: Encoder(d), lambda: Decoder(d),
                 lambda: CompressedStringStore(d, corpus),
                 lambda: CompressedStringStore.build(titles[:50]),
                 lambda: ops.OnPairDevice(d)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert Encoder(d, device="cpu").encode_one(b"abc")


def test_decode_counter_and_spans_reach_obs(port_store, titles):
    """A traced multiget records store.decode -> kernel.decode_batch, and the
    registry exports the decode counter by path, as the reference names them.
    The tracer is cleared first: ``trace_dump`` keeps the slowest traces of
    the process, which slower traces of earlier tests could fill."""
    TRACER.clear()
    with TRACER.span("client.multiget", root=True) as ctx:
        assert port_store.multiget([5, 6]) == titles[5:7]
    trace = next(t for t in TRACER.trace_dump(64) if t["trace_id"] == ctx.trace_id)
    names = [s["name"] for s in trace["spans"]]
    assert names[:2] == ["client.multiget", "store.decode"]
    assert "kernel.decode_batch" in names
    kernel = next(s for s in trace["spans"] if s["name"] == "kernel.decode_batch")
    assert kernel["annotations"]["path"] == "ref"
    series = {(m["name"], tuple(sorted(m["labels"].items()))): m
              for m in REGISTRY.snapshot()["metrics"]}
    key = ("repro_kernel_decode_batches_total", (("path", "ref"),))
    assert series[key]["value"] >= 1
    assert series[("repro_kernel_decode_batches_total", (("path", "cuda"),))][
        "value"] == 0
    lat = series[("repro_store_multiget_latency_us", (("backend", "cpu"),))]
    assert sum(lat["counts"]) >= 1


#: counters of the reference's snapshot that arrive with a later slice of the
#: port (none since the cold tier)
NOT_PORTED_YET: set[str] = set()


@pytest.mark.parametrize("cache_bytes", [0, 8 << 20])
@pytest.mark.parametrize("which", ["built", "converted"])
def test_memory_bytes_equals_reference(ref_comp, titles, cache_bytes, which):
    """The reference's quantity: segments + the dictionary's resident bytes +
    cache + tail. Over bare device tables ("converted") the port counts the
    same bytes from the tables. The device tables are a key of their own."""
    comp, corpus = ref_comp
    d = comp.dictionary
    if which == "built":
        dictionary = PackedDictionary.build(d.entries)
    else:
        dictionary = convert.dictionary_from_reference(
            {k: getattr(d, k) for k in ref.ARRAY_FIELDS}, d.s_probe_max,
            d.p_probe_max, max(1, d.max_bucket_size), device="cpu")
    kw = dict(strings_per_segment=SEG, cache_bytes=cache_bytes)
    store = CompressedStringStore(dictionary, corpus, device="cpu", **kw)
    want = RefStore(comp, corpus, backend="numpy", **kw)
    assert store.memory_bytes == want.memory_bytes
    ids = _ids(len(titles), 5, size=300)
    assert store.multiget(ids) == want.multiget(ids)
    assert store.cache.current_bytes == want.cache.current_bytes
    assert (store.cache.current_bytes > 0) == (cache_bytes > 0)
    assert store.memory_bytes == want.memory_bytes
    snap = store.stats_snapshot()
    assert snap["memory_bytes"] == want.stats_snapshot()["memory_bytes"]
    assert snap["device_dict_bytes"] == store._device.dd.nbytes > 0


def test_stats_snapshot_keys_match_reference(ref_comp, titles):
    """After the same multigets the port's snapshot has the reference's keys,
    less the not-yet-ported counters and plus the device table bytes, and
    its latency histogram merges with the reference's."""
    comp, corpus = ref_comp
    kw = dict(strings_per_segment=SEG, cache_bytes=1 << 16)
    store = CompressedStringStore(PackedDictionary.build(comp.dictionary.entries),
                                  corpus, device="cpu", **kw)
    want = RefStore(comp, corpus, backend="numpy", **kw)
    for seed in (1, 2, 3):
        ids = _ids(len(titles), seed, size=200)
        assert store.multiget(ids) == want.multiget(ids)
    snap, ref_snap = store.stats_snapshot(), want.stats_snapshot()
    assert NOT_PORTED_YET <= set(ref_snap)
    assert set(snap) == (set(ref_snap) - NOT_PORTED_YET) | {"device_dict_bytes"}
    assert snap["cold_lookups"] == ref_snap["cold_lookups"] == 0
    assert snap["jit_shapes"] and all(b == 256 for b, _ in snap["jit_shapes"])
    hist, ref_hist = snap["multiget_latency_hist"], ref_snap["multiget_latency_hist"]
    assert hist["bounds"] == ref_hist["bounds"] and sum(hist["counts"]) == 3
    merged = merge_hist_states([hist, ref_hist])
    assert merged["counts"] == [a + b for a, b in zip(hist["counts"],
                                                      ref_hist["counts"])]
    assert merged["sum"] == pytest.approx(hist["sum"] + ref_hist["sum"])
