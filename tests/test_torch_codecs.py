"""The codec registry and every codec of the paper's Table 3 on the port,
held against the JAX package's, byte for byte.

The same seeded titles train each registered codec in both packages
(``registry.train``, BPE and FSST on a 128 KiB sample, the others on 256
KiB), once per module. Covered: the artifacts' bytes (the wall-clock
``train_seconds`` of the training stats aside) and each corpus's payload,
offsets and meta; ``decompress_all`` and ``access`` against the source and
across packages; the registry's names, aliases, capabilities, unknown names
and factories; the host batch parse ``parse_batch`` against the reference's,
``DynamicLPM.parse`` and, for OnPair16, the encode kernel's plain version;
``PackedDictionary`` field by field, bounded and unbounded, with its host
``decode_tokens``/``decode_string``; the analysis functions of
``core.metrics`` and ``dataset_stats``; ``Encoder``/``Decoder`` over every
artifact, on the host for the codecs with no kernel (an explicit ``device=``
raises) and on the kernels' plain versions for OnPair16; and the reference's
own codec cases (``tests/test_core_onpair.py`` round trips and the paper's
ratio ordering) run against the port."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import metrics as ref_metrics
from repro.core import registry as ref_registry
from repro.core.codec import Encoder as RefEncoder
from repro.core.lpm import lpm_from_entries as ref_lpm_from_entries
from repro.core.lpm import parse_batch as ref_parse_batch
from repro.core.packed import PackedDictionary as RefPacked
from repro.data.synth import dataset_stats as ref_dataset_stats
from repro.data.synth import load_dataset as ref_load_dataset
from repro_torch.core import (BPECompressor, DictArtifact, FSSTCompressor,
                              OnPairCompressor, RawCompressor, make_onpair,
                              make_onpair16, metrics, registry)
from repro_torch.core.codec import Decoder, Encoder
from repro_torch.core.lpm import lpm_from_entries, parse_batch
from repro_torch.core.packed import PackedDictionary
from repro_torch.data.synth import dataset_stats, load_dataset
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

SAMPLE = 1 << 18
#: training samples: BPE and FSST train in Python loops over their sample
SMALL = {"bpe": 1 << 17, "fsst": 1 << 17}
CPU = torch.device("cpu")
CODECS = ref_registry.names()  # zstd-block drops out without zstandard
HOST_CODECS = [n for n in CODECS
               if not ref_registry.capabilities(n).device_decodable]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small: torch's intra-op threads would only
    contend with XLA's thread pool in the same process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def titles():
    strings = load_dataset("book_titles", SAMPLE)
    assert strings == ref_load_dataset("book_titles", SAMPLE)
    strings[3] = b""
    strings[7] = b"\x00\xff" * 9
    strings[11] = bytes(range(256))
    return strings


def _train(reg, name, strings):
    if not reg.capabilities(name).trainable:
        return reg.create(name).to_artifact()
    return reg.train(name, strings, sample_bytes=SMALL.get(name, SAMPLE))


@pytest.fixture(scope="module")
def trained(titles):
    """codec name -> (port artifact, port corpus, ref artifact, ref corpus)."""
    out = {}
    for name in CODECS:
        pa, ra = _train(registry, name, titles), _train(ref_registry, name, titles)
        out[name] = (pa, registry.codec_from_artifact(pa).compress(titles),
                     ra, ref_registry.codec_from_artifact(ra).compress(titles))
    return out


def _timeless(art):
    """The artifact with the training stats' wall clock zeroed: every other
    byte is deterministic."""
    if "train_seconds" not in art.stats:
        return art
    return dataclasses.replace(art, stats={**art.stats, "train_seconds": 0.0})


def _same_corpus(got, want):
    assert got.payload.tobytes() == want.payload.tobytes()
    np.testing.assert_array_equal(got.offsets, want.offsets)
    assert got.offsets.dtype == want.offsets.dtype == np.int64
    assert got.raw_bytes == want.raw_bytes
    assert got.meta.keys() == want.meta.keys()
    for k, v in want.meta.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got.meta[k], v)
            assert got.meta[k].dtype == v.dtype
        else:
            assert got.meta[k] == v


# ------------------------------------------------------------ byte parity
@pytest.mark.parametrize("name", CODECS)
def test_artifact_bytes_equal_reference(trained, name):
    pa, _, ra, _ = trained[name]
    assert pa.codec == ra.codec
    assert registry.resolve(pa.codec) == name
    assert _timeless(pa).to_bytes() == _timeless(ra).to_bytes()
    again = DictArtifact.from_bytes(ra.to_bytes())
    assert again.entries == pa.entries


@pytest.mark.parametrize("name", CODECS)
def test_corpus_payload_and_offsets_equal_reference(trained, name):
    _, pc, _, rc = trained[name]
    _same_corpus(pc, rc)
    assert pc.ratio == rc.ratio
    assert pc.to_bytes() == rc.to_bytes()


@pytest.mark.parametrize("name", CODECS)
def test_decompress_all_and_access_equal_source(trained, titles, name):
    pa, pc, ra, rc = trained[name]
    codec = registry.codec_from_artifact(pa)
    assert codec.decompress_all(pc) == b"".join(titles)
    rng = np.random.default_rng(0)
    for i in [0, 3, 7, 11, len(titles) - 1] + rng.integers(0, len(titles), 40).tolist():
        assert codec.access(pc, int(i)) == titles[int(i)]
    # each package decodes the other's corpus from the other's artifact
    assert codec.decompress_all(rc) == b"".join(titles)
    ref_codec = ref_registry.codec_from_artifact(ra)
    assert ref_codec.decompress_all(pc) == b"".join(titles)
    assert ref_codec.access(pc, 11) == titles[11]


@pytest.mark.parametrize("name", CODECS)
def test_codec_compress_string_and_single_strings(trained, titles, name):
    pa, _, ra, _ = trained[name]
    codec = registry.codec_from_artifact(pa)
    ref_codec = ref_registry.codec_from_artifact(ra)
    for s in (b"", titles[0], titles[11], b"x" * 300):
        got, want = codec.compress([s]), ref_codec.compress([s])
        _same_corpus(got, want)
        assert codec.access(got, 0) == s
    if hasattr(ref_codec, "compress_string"):
        assert codec.compress_string(titles[5]) == ref_codec.compress_string(titles[5])


# --------------------------------------------------------------- registry
def test_registry_names_aliases_and_caps_equal_reference():
    assert registry.names() == ref_registry.names()
    assert registry.names(include_unavailable=True) == \
        ref_registry.names(include_unavailable=True)
    for name in ref_registry.names(include_unavailable=True) + ["zlib-block"]:
        assert registry.resolve(name) == ref_registry.resolve(name)
        assert dataclasses.asdict(registry.capabilities(name)) == \
            dataclasses.asdict(ref_registry.capabilities(name))
        spec, ref_spec = registry.get_spec(name), ref_registry.get_spec(name)
        assert (spec.name, spec.aliases, spec.available,
                spec.unavailable_reason) == (ref_spec.name, ref_spec.aliases,
                                             ref_spec.available,
                                             ref_spec.unavailable_reason)
    assert registry.resolve("zlib-block") == "lz-block"
    assert [n for n in registry.names()
            if registry.capabilities(n).device_decodable] == ["onpair16"]


def test_registry_unknown_name_raises_like_reference():
    with pytest.raises(KeyError) as got:
        registry.resolve("nope-codec")
    with pytest.raises(KeyError) as want:
        ref_registry.resolve("nope-codec")
    assert str(got.value) == str(want.value)
    with pytest.raises(KeyError):
        registry.create("nope-codec")
    with pytest.raises(KeyError):
        registry.codec_from_artifact(DictArtifact.from_config("nope-codec"))


def test_registry_creates_the_ports_own_classes():
    # the paper's six rows from the registry, none of them a reference class
    for name in ("onpair", "onpair16", "bpe", "fsst", "lz-block", "raw"):
        codec = registry.create(name)
        assert type(codec).__module__.startswith("repro_torch.core."), name
        assert hasattr(codec, "train") and hasattr(codec, "compress")
    assert isinstance(registry.create("onpair"), OnPairCompressor)
    assert registry.create("onpair").name == "onpair"
    assert registry.create("onpair16").name == "onpair16"
    assert isinstance(registry.create("bpe"), BPECompressor)
    assert isinstance(registry.create("fsst"), FSSTCompressor)
    assert isinstance(registry.create("raw"), RawCompressor)
    assert registry.create("zlib-block").name == "zlib-block"


# ------------------------------------------------- the host batch parse
@pytest.mark.parametrize("name", ["onpair16", "onpair", "bpe"])
def test_parse_batch_equals_reference_and_dynamic_parse(trained, titles, name):
    pa, _, ra, _ = trained[name]
    d, rd = PackedDictionary.build(pa.entries), RefPacked.build(ra.entries)
    strings = titles[:1500] + [b"", b"a", bytes(range(256)) * 3]
    payload, counts = parse_batch(d, strings, chunk=512)
    want_payload, want_counts = ref_parse_batch(rd, strings, chunk=512)
    assert payload.tobytes() == want_payload.tobytes()
    np.testing.assert_array_equal(counts, want_counts)
    lpm = lpm_from_entries(pa.entries)
    ref_lpm = ref_lpm_from_entries(ra.entries)
    ends = np.cumsum(counts)
    for k in (0, 3, 7, 11, 500, len(strings) - 1):
        toks = payload[ends[k] - counts[k] : ends[k]].tolist()
        assert toks == lpm.parse(strings[k]) == ref_lpm.parse(strings[k])


def test_onpair16_parse_batch_equals_the_encode_kernels_plain_version(
        trained, titles):
    pa = trained["onpair16"][0]
    d = PackedDictionary.build(pa.entries)
    strings = titles[:800] + [b"", bytes(range(256))]
    payload, counts = parse_batch(d, strings)
    data, lens = ops.pack_strings(strings)
    toks, n = kref.encode_batch_ref(torch.from_numpy(data), torch.from_numpy(lens),
                                    kref.DeviceDict.build(d, CPU), data.shape[1] - 16)
    np.testing.assert_array_equal(counts, n.numpy())
    keep = np.arange(toks.shape[1])[None, :] < n.numpy()[:, None]
    np.testing.assert_array_equal(payload, toks.numpy()[keep].astype("<u2"))


# ---------------------------------------------------------- PackedDictionary
@pytest.mark.parametrize("name", ["onpair16", "onpair", "bpe"])
def test_packed_dictionary_equals_reference_field_by_field(trained, name):
    pa, _, ra, _ = trained[name]
    got, want = PackedDictionary.build(pa.entries), RefPacked.build(ra.entries)
    fields = [f.name for f in dataclasses.fields(want)]
    assert fields == [f.name for f in dataclasses.fields(got)]
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert g == w, f
    assert got.variant16 == (name == "onpair16")
    for prop in ("num_entries", "data_bytes", "total_bytes", "resident_bytes"):
        assert getattr(got, prop) == getattr(want, prop), prop


@pytest.mark.parametrize("name", ["onpair16", "onpair", "bpe"])
@pytest.mark.parametrize("n_tokens", [0, 1, 64, 65, 5000])
def test_decode_tokens_and_decode_string_equal_reference(trained, name, n_tokens):
    pa, _, ra, _ = trained[name]
    got, want = PackedDictionary.build(pa.entries), RefPacked.build(ra.entries)
    rng = np.random.default_rng(n_tokens)
    toks = rng.integers(0, got.num_entries, n_tokens)
    if n_tokens > 64:
        # every entry longer than 16 bytes, so the tail pass runs
        toks[: (got.lens > 16).sum()] = np.flatnonzero(got.lens > 16)[:n_tokens]
    expect = b"".join(pa.entries[t] for t in toks)
    assert got.decode_tokens(toks) == want.decode_tokens(toks) == expect
    packed = toks.astype("<u2").tobytes()
    assert got.decode_string(packed) == want.decode_string(packed) == expect


def test_unbounded_dictionaries_hold_long_entries(trained):
    # the tail pass above is exercised only if a codec trained a >16 B entry
    assert max(map(len, trained["onpair"][0].entries)) > 16
    assert max(map(len, trained["onpair16"][0].entries)) <= 16


# ----------------------------------------------------------------- metrics
@pytest.mark.parametrize("name", ["onpair16", "onpair", "bpe"])
def test_metrics_equal_reference(trained, name):
    pa, pc, ra, rc = trained[name]
    d, rd = PackedDictionary.build(pa.entries), RefPacked.build(ra.entries)
    toks = np.asarray(pc.payload.view("<u2"))
    n = d.num_entries
    np.testing.assert_array_equal(metrics.token_frequencies(toks, n),
                                  ref_metrics.token_frequencies(toks, n))
    np.testing.assert_array_equal(metrics.gain_by_token(d, toks),
                                  ref_metrics.gain_by_token(rd, toks))
    assert metrics.gain_by_length(d, toks) == ref_metrics.gain_by_length(rd, toks)
    assert metrics.gain_by_length(d, toks, 4) == ref_metrics.gain_by_length(rd, toks, 4)
    assert metrics.bucket_size_histogram(d) == ref_metrics.bucket_size_histogram(rd)
    assert metrics.avg_token_length(d, toks) == ref_metrics.avg_token_length(rd, toks)
    assert metrics.avg_token_length(d, toks[:0]) == 0.0
    for a, b in zip(metrics.cumulative_coverage(d, toks),
                    ref_metrics.cumulative_coverage(rd, toks)):
        np.testing.assert_array_equal(a, b)
    for length, freq in ((1, 10), (2, 0), (16, 1000), (40, 3)):
        assert metrics.token_gain(length, freq) == ref_metrics.token_gain(length, freq)


def test_serving_metrics_equal_reference():
    rng = np.random.default_rng(3)
    samples = rng.exponential(1e-3, 5000).tolist()
    assert metrics.latency_summary(samples) == ref_metrics.latency_summary(samples)
    assert metrics.latency_summary([]) == ref_metrics.latency_summary([])
    assert metrics.latency_summary(samples, (50.0, 90.0, 99.9)) == \
        ref_metrics.latency_summary(samples, (50.0, 90.0, 99.9))
    assert metrics.throughput_mib_s(3 << 20, 0.5) == \
        ref_metrics.throughput_mib_s(3 << 20, 0.5)
    assert metrics.throughput_mib_s(1, 0.0) == ref_metrics.throughput_mib_s(1, 0.0)
    got, want = metrics.LatencyReservoir(100), ref_metrics.LatencyReservoir(100)
    for s in samples[:350]:
        got.record(s)
        want.record(s)
    assert got.summary() == want.summary()


def test_dataset_stats_equal_reference(titles):
    assert dataset_stats(titles) == ref_dataset_stats(titles)
    assert dataset_stats([b"ab", b"", b"cde"]) == ref_dataset_stats([b"ab", b"", b"cde"])


# ------------------------------------------------------------ Encoder/Decoder
@pytest.mark.parametrize("name", HOST_CODECS)
def test_encoder_decoder_run_host_codecs(trained, titles, name):
    pa, pc, ra, rc = trained[name]
    enc, dec = Encoder(pa), Decoder(pa)
    assert enc.backend == dec.backend == "numpy"
    _same_corpus(enc.encode(titles), rc)
    assert enc.encode_one(titles[5]) == RefEncoder(ra).encode_one(titles[5])
    assert dec.decode_all(pc) == b"".join(titles)
    assert dec.access(pc, 7) == titles[7]
    ids = [11, 3, 0, 11, len(titles) - 1]
    assert dec.multiget(pc, ids) == [titles[i] for i in ids]
    caps = registry.capabilities(name)
    if caps.token_stream:
        assert dec.dictionary.entries == pa.entries
    elif name != "fsst":
        assert dec.dictionary is None


@pytest.mark.parametrize("name", HOST_CODECS)
@pytest.mark.parametrize("device", ["cuda", "cpu", CPU])
def test_explicit_device_for_a_host_codec_raises(trained, name, device):
    pa = trained[name][0]
    for cls in (Encoder, Decoder):
        with pytest.raises(ValueError,
                           match=r"is not device-decodable \(registry capability\)"):
            cls(pa, device=device)


def test_onpair16_artifact_runs_on_the_kernels_plain_versions(trained, titles):
    pa, pc, _, rc = trained["onpair16"]
    enc, dec = Encoder(pa, device=CPU), Decoder(pa, device=CPU)
    assert enc.backend == dec.backend == "cpu"
    _same_corpus(enc.encode(titles), rc)
    assert dec.decode_all(pc) == b"".join(titles)
    assert dec.multiget(pc, [3, 11, 7]) == [titles[3], titles[11], titles[7]]


def test_onpair16_host_codec_equals_the_device_encoder(trained, titles):
    # compress of the host codec (parse_batch) == the encode kernel's plain
    # version through the Encoder: the comparison the chip phase makes
    pa, pc, _, _ = trained["onpair16"]
    host = registry.codec_from_artifact(pa).compress(titles)
    dev = Encoder(pa, device=CPU).encode(titles)
    assert host.payload.tobytes() == dev.payload.tobytes() == pc.payload.tobytes()
    np.testing.assert_array_equal(host.offsets, dev.offsets)


# ---------------------------------- the reference's own codec cases, ported
@pytest.fixture(scope="module")
def big_titles():
    return load_dataset("book_titles", 1 << 19)


@pytest.mark.parametrize("name", ["raw", "zlib-block", "zstd-block", "fsst",
                                  "onpair", "onpair16"])
def test_roundtrip_all_compressors(big_titles, name):
    """``tests/test_core_onpair.py::test_roundtrip_all_compressors`` on the
    port, with the reference's payload beside it."""
    if name == "zstd-block" and not registry.get_spec(name).available:
        assert not ref_registry.get_spec(name).available
        return
    strings = big_titles[:4000]
    kw = {"sample_bytes": SMALL["fsst"]} if name == "fsst" else {}
    c, rc = registry.create(name, **kw), ref_registry.create(name, **kw)
    c.train(strings, sum(map(len, strings)))
    rc.train(strings, sum(map(len, strings)))
    corpus = c.compress(strings)
    _same_corpus(corpus, rc.compress(strings))
    assert c.decompress_all(corpus) == b"".join(strings)
    rng = np.random.default_rng(0)
    for i in rng.integers(0, len(strings), 25):
        assert c.access(corpus, int(i)) == strings[int(i)]


def test_bpe_roundtrip_small(big_titles):
    """``tests/test_core_onpair.py::test_bpe_roundtrip_small`` on the port."""
    strings = big_titles[:1500]
    c = BPECompressor(sample_bytes=1 << 17)
    c.train(strings)
    corpus = c.compress(strings)
    assert c.decompress_all(corpus) == b"".join(strings)
    assert c.access(corpus, 3) == strings[3]
    rc = ref_registry.create("bpe", sample_bytes=1 << 17)
    rc.train(strings)
    _same_corpus(corpus, rc.compress(strings))


def test_paper_claim_ratio_ordering(trained, titles):
    """The paper's Table 3 ordering, as ``tests/test_core_onpair.py``
    asserts it: OnPair >= 0.98 x OnPair16, and OnPair16 > 1.1 x FSST."""
    rs = {}
    for name in ("onpair", "onpair16", "fsst"):
        rs[name] = registry.codec_from_artifact(trained[name][0]).compress(
            titles[:3000]).ratio
    assert rs["onpair"] >= rs["onpair16"] * 0.98
    assert rs["onpair16"] > rs["fsst"] * 1.1


def test_make_onpair_factories_and_config(titles):
    a, b = make_onpair(sample_bytes=1 << 16), make_onpair16(sample_bytes=1 << 16)
    assert (a.name, b.name) == ("onpair", "onpair16")
    assert a.cfg.codec_name == "onpair" and b.cfg.max_entry_len == 16
    b.train(titles)
    art = b.to_artifact()
    assert art.config["max_entry_len"] == 16 and art.stats["dict_entries"] == len(art.entries)
    again = OnPairCompressor.from_artifact(art)
    assert again.cfg == b.cfg and again.dictionary.entries == b.dictionary.entries
