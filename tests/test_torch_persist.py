"""Save/open across the two packages: every file one writes, the other opens
and serves the same bytes from. The port runs on ``device="cpu"`` (the
kernels' plain versions), the reference on its numpy backend, over the same
seeded titles. Covered: the artifact container byte for byte, corpora,
artifacts through decode and re-encode, read stores, writable stores with
an unsealed tail, compact()'s versioned swap, the index.npz sidecar, and
stores with cold segments (read and writable, with their cold-*.rlz
files)."""

import json
import os
import warnings

import numpy as np
import pytest
import torch

from repro.core import registry
from repro.core.api import CompressedCorpus as RefCorpus
from repro.core.artifact import DictArtifact as RefArtifact
from repro.core.artifact import dump_container as ref_dump_container
from repro.core.artifact import read_container as ref_read_container
from repro.core.codec import Decoder as RefDecoder
from repro.core.codec import Encoder as RefEncoder
from repro.core.packed import PackedDictionary as RefPacked
from repro.data.synth import load_dataset as ref_load_dataset
from repro.store import CompressedStringStore as RefStore
from repro.store import MutableStringStore as RefMutable
from repro_torch import convert
from repro_torch.core import CompressedCorpus, Decoder, DictArtifact, Encoder
from repro_torch.core.artifact import dump_container, read_container
from repro_torch.core.onpair import OnPairConfig
from repro_torch.core.packed import PackedDictionary
from repro_torch.data.synth import load_dataset
from repro_torch.kernels import ref
from repro_torch.kernels.ops import OnPairDevice
from repro_torch.store import CompressedStringStore, MutableStringStore

SAMPLE = 1 << 18
SPS = 256
CPU = torch.device("cpu")
DIRECTIONS = ["port_to_ref", "ref_to_port"]


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
    strings[3] = b""                      # empties survive round-trips
    strings[7] = b"\x00\xff" * 9          # binary-safe
    strings[11] = strings[5]              # a duplicate: locate gives id 5
    return strings


@pytest.fixture(scope="module")
def ref_art(titles):
    return registry.train("onpair16", titles, sample_bytes=SAMPLE)


@pytest.fixture(scope="module")
def port_art(ref_art):
    """The reference's artifact as the port reads it: through its bytes."""
    return DictArtifact.from_bytes(ref_art.to_bytes())


@pytest.fixture(scope="module")
def ref_corpus(ref_art, titles):
    return RefEncoder(ref_art).encode(titles)


def _first(strings):
    first: dict[bytes, int] = {}
    for i, s in enumerate(strings):
        first.setdefault(s, i)
    return first


# ----------------------------------------------------------- the container
def test_artifact_container_bytes_equal_reference(ref_art):
    """The same codec, config, arrays and stats give the same bytes, from
    the constructor and from ``from_entries``; so does any container."""
    port = DictArtifact(codec=ref_art.codec, config=ref_art.config,
                        arrays=ref_art.arrays, stats=ref_art.stats)
    assert port.to_bytes() == ref_art.to_bytes()
    again = DictArtifact.from_entries(ref_art.codec, ref_art.entries,
                                      config=ref_art.config, stats=ref_art.stats)
    assert again.to_bytes() == ref_art.to_bytes()
    assert again.num_entries == ref_art.num_entries
    assert again.data_bytes == ref_art.data_bytes
    header = {"kind": "x", "nested": {"b": [1, 2], "a": None}}
    arrays = {"u8": np.arange(7, dtype=np.uint8),
              "empty": np.zeros((0, 3), dtype=np.int32),
              "f": np.linspace(0, 1, 5).reshape(5, 1),
              "strided": np.arange(40, dtype=np.int64)[::3]}
    assert dump_container(header, arrays) == ref_dump_container(header, arrays)
    assert DictArtifact.from_config("raw").to_bytes() == \
        RefArtifact.from_config("raw").to_bytes()


def test_packed_dictionary_bytes_equal_reference(ref_art, tmp_path):
    """A bare dictionary ships as its artifact: the same bytes as the
    reference's PackedDictionary, and back to the same tables."""
    port = PackedDictionary.from_artifact(DictArtifact.from_bytes(ref_art.to_bytes()))
    want = RefPacked.build(ref_art.entries)
    assert port.to_bytes() == want.to_bytes()
    assert port.to_artifact().codec == "onpair16"
    path = str(tmp_path / "d.rpa")
    port.save(path)
    for again in (PackedDictionary.load(path), PackedDictionary.from_bytes(
            want.to_bytes())):
        assert again.entries == ref_art.entries
        for field in ("mat16", "lens", "s_lo", "p_lo", "suf_tok"):
            np.testing.assert_array_equal(getattr(again, field), getattr(want, field))
    assert RefPacked.load(path).entries == ref_art.entries


def test_artifact_bad_magic_and_lazy_mmap(ref_art, tmp_path):
    for cls in (DictArtifact, CompressedCorpus):
        with pytest.raises(ValueError):
            cls.from_bytes(b"not an artifact container at all")
    bad = tmp_path / "bad.rpa"
    bad.write_bytes(b"RPROART0" + bytes(64))
    with pytest.raises(ValueError):
        DictArtifact.load(str(bad))
    # a container of another kind is refused by name
    with pytest.raises(ValueError, match="not a dict_artifact"):
        DictArtifact.from_bytes(CompressedCorpus(
            np.zeros(0, np.uint8), np.zeros(1, np.int64), 0).to_bytes())
    path = str(tmp_path / "d.rpa")
    ref_art.save(path)
    loaded = DictArtifact.load(path, mmap=True)
    assert isinstance(loaded.arrays["blob"], np.memmap)
    assert not loaded.arrays["blob"].flags.writeable
    assert loaded.entries == ref_art.entries and loaded.config == ref_art.config
    assert DictArtifact.load(path, mmap=False).to_bytes() == ref_art.to_bytes()
    # a zero-byte array is made, never mapped
    DictArtifact("x", arrays={"z": np.zeros(0, np.uint8)}).save(path)
    z = DictArtifact.load(path).arrays["z"]
    assert z.size == 0 and not isinstance(z, np.memmap)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_corpus_save_load_across_packages(port_art, ref_corpus, titles, tmp_path,
                                          direction):
    """A corpus saved by either package loads in the other with the same
    payload, offsets and raw_bytes; the port's encode of the same strings
    saves to the same corpus.rpc bytes."""
    port_corpus = Encoder(port_art, device=CPU).encode(titles)
    a, b = str(tmp_path / "port.rpc"), str(tmp_path / "ref.rpc")
    port_corpus.save(a)
    ref_corpus.save(b)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert port_corpus.to_bytes() == ref_corpus.to_bytes()
    loaded = RefCorpus.load(a) if direction == "port_to_ref" else \
        CompressedCorpus.load(b)
    assert loaded.raw_bytes == ref_corpus.raw_bytes
    assert loaded.payload.tobytes() == ref_corpus.payload.tobytes()
    np.testing.assert_array_equal(loaded.offsets, ref_corpus.offsets)
    assert loaded.meta == ref_corpus.meta
    for lo, hi in ((0, 100), (37, 999), (500, 500)):
        got, want = port_corpus.slice_strings(lo, hi), ref_corpus.slice_strings(lo, hi)
        assert got.raw_bytes == want.raw_bytes
        np.testing.assert_array_equal(got.offsets, want.offsets)
        assert got.payload.tobytes() == want.payload.tobytes()
        assert [got.string_payload(i) for i in range(got.n_strings)] == \
            [want.string_payload(i) for i in range(want.n_strings)]


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_artifact_save_load_decode_reencode(ref_art, ref_corpus, titles,
                                            tmp_path, direction):
    """train -> save -> load -> decode and re-encode, identical across the
    packages (onpair16)."""
    path = str(tmp_path / "d.rpa")
    if direction == "port_to_ref":
        store = CompressedStringStore.build(titles, sample_bytes=SAMPLE,
                                            device=CPU, strings_per_segment=SPS)
        store.artifact.save(path)
        loaded = RefArtifact.load(path)
        dec, enc = RefDecoder(loaded), RefEncoder(loaded)
        assert loaded.config == store.artifact.config
    else:
        ref_art.save(path)
        loaded = DictArtifact.load(path)
        dec, enc = Decoder(loaded, device=CPU), Encoder(loaded, device=CPU)
    assert loaded.entries == ref_art.entries
    assert loaded.codec == "onpair16"
    assert dec.decode_all(ref_corpus) == b"".join(titles)
    for i in (0, 3, 7, 42, len(titles) - 1):
        assert dec.access(ref_corpus, i) == titles[i]
    again = enc.encode(titles)
    assert again.payload.tobytes() == ref_corpus.payload.tobytes()
    np.testing.assert_array_equal(again.offsets, ref_corpus.offsets)


def test_from_artifact_refuses_what_the_kernels_cannot_decode(port_art):
    ref_art = port_art
    other = DictArtifact.from_entries("onpair", ref_art.entries)
    with pytest.raises(ValueError, match="not device-decodable"):
        OnPairDevice.from_artifact(other, device=CPU)
    long = DictArtifact.from_entries("onpair16", ref_art.entries[:300] + [b"x" * 17])
    with pytest.raises(ValueError, match="<=16B"):
        OnPairDevice.from_artifact(long, device=CPU)
    assert OnPairDevice.from_artifact(ref_art, device=CPU).dictionary.entries \
        == ref_art.entries
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            OnPairDevice.from_artifact(ref_art)


# ------------------------------------------------------------- read stores
def _build_read(direction, titles, **kw):
    kw.setdefault("strings_per_segment", 512)
    if direction == "port_to_ref":
        return CompressedStringStore.build(titles, sample_bytes=SAMPLE, device=CPU,
                                           **kw)
    return RefStore.build(titles, sample_bytes=SAMPLE, backend="numpy", **kw)


def _open_read(direction, d, **kw):
    if direction == "port_to_ref":
        return RefStore.open(d, backend="numpy", **kw)
    return CompressedStringStore.open(d, device=CPU, **kw)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_read_store_save_open_across_packages(titles, tmp_path, direction):
    """A read store saved by either package opens in the other and serves
    identical multiget/get/scan, with the saved params back; both packages
    write the same store.json and the same corpus.rpc for it."""
    store = _build_read(direction, titles, cache_bytes=1 << 16, batch_size=128)
    d = str(tmp_path / "store")
    store.save(d)
    reopened = _open_read(direction, d)
    rng = np.random.default_rng(11)
    ids = rng.integers(0, len(titles), 800).tolist()
    assert reopened.multiget(ids) == store.multiget(ids) == [titles[i] for i in ids]
    assert reopened.get(7) == store.get(7) == titles[7]
    assert reopened.scan(400, 700) == store.scan(400, 700) == titles[400:700]
    assert reopened.scan(0, len(titles)) == titles
    assert reopened.segments.strings_per_segment == 512
    assert reopened.cache.capacity_bytes == 1 << 16 and reopened.batch_size == 128
    assert reopened.memory_bytes == store.memory_bytes
    # the other package saves the reopened store to the same files
    d2 = str(tmp_path / "again")
    reopened.save(d2)
    for name in ("store.json", "corpus.rpc"):
        assert open(os.path.join(d, name), "rb").read() == \
            open(os.path.join(d2, name), "rb").read(), name
    with open(os.path.join(d, "store.json")) as f:
        meta = json.load(f)
    assert meta["codec"] == "onpair16" and meta["n_strings"] == len(titles)
    a, b = DictArtifact.load(os.path.join(d, "dictionary.rpa")), \
        DictArtifact.load(os.path.join(d2, "dictionary.rpa"))
    assert a.entries == b.entries and a.config == b.config


def test_opened_store_serves_from_read_only_maps(titles, tmp_path):
    """mmap=True (the default): the corpus arrays are read-only maps, and
    opening, reading, locating and appending neither write into them nor
    hand them to torch uncopied (torch warns on a non-writable array)."""
    store = MutableStringStore.build(titles[:1000], sample_bytes=SAMPLE, device=CPU,
                                     strings_per_segment=SPS)
    store.extend(titles[1000:1100])
    d = str(tmp_path / "ro")
    store.save(d)
    q = titles[1050]
    gid = _first(titles[:1100])[q]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for m in (MutableStringStore.open(d, device=CPU),
                  CompressedStringStore.open(d, device=CPU)):
            assert not m.corpus.payload.flags.writeable
            assert m.scan(0, 1100) == titles[:1100]
            assert m.multiget([5, 1050, 3]) == [titles[5], titles[1050], titles[3]]
            assert m.locate(q) == gid
            assert m.scan_prefix(q, limit=1) == [(gid, q)]
            assert Decoder(m.artifact, device=CPU).decode_all(m.corpus) == \
                b"".join(titles[: m.corpus.n_strings])
        m = MutableStringStore.open(d, device=CPU)
        m.extend(titles[1100:1400])
        m.seal_barrier()
        assert m.scan(0, 1400) == titles[:1400]
        m.compact()
        assert m.scan(0, 1400) == titles[:1400]


def test_artifact_from_device_tables_equals_host(port_art, ref_corpus, titles,
                                                 tmp_path):
    """A store opened from an artifact and one over the same dictionary's
    converted device tables (convert.py, no host dictionary) save the same
    entries."""
    ref_art = port_art
    d = PackedDictionary.build(ref_art.entries)
    dd = convert.dictionary_from_reference(
        {k: getattr(d, k) for k in ref.ARRAY_FIELDS}, d.s_probe_max,
        d.p_probe_max, max(1, d.max_bucket_size), device="cpu")
    assert dd.entries() == ref_art.entries
    corpus = convert.corpus_from_reference(ref_corpus.payload, ref_corpus.offsets,
                                           ref_corpus.raw_bytes)
    a = CompressedStringStore(port_art, corpus, device=CPU, strings_per_segment=SPS)
    b = CompressedStringStore(dd, corpus, device=CPU, strings_per_segment=SPS)
    assert a.artifact is port_art
    assert a.config == OnPairConfig(**port_art.config)
    assert b.config is None and b.artifact.config == {}
    for store, name in ((a, "a"), (b, "b")):
        store.save(str(tmp_path / name))
    ea = DictArtifact.load(str(tmp_path / "a" / "dictionary.rpa")).entries
    eb = RefArtifact.load(str(tmp_path / "b" / "dictionary.rpa")).entries
    assert ea == eb == ref_art.entries
    assert RefStore.open(str(tmp_path / "b")).scan(0, len(titles)) == titles


# --------------------------------------------------------- writable stores
def _mutable(direction, art, strings, **kw):
    kw.setdefault("strings_per_segment", SPS)
    kw.setdefault("cache_bytes", 1 << 20)
    if direction == "port_to_ref":
        art = DictArtifact.from_bytes(art.to_bytes())
        corpus = Encoder(art, device=CPU).encode(strings)
        return MutableStringStore(art, corpus, device=CPU, **kw)
    art = RefArtifact.from_bytes(art.to_bytes())
    return RefMutable(art, RefEncoder(art).encode(strings), **kw)


def _open_mutable(direction, d, **kw):
    if direction == "port_to_ref":
        return RefMutable.open(d, **kw)
    return MutableStringStore.open(d, device=CPU, **kw)


def _drift(store):
    dm = store.drift
    return (dm.raw_bytes, dm.compressed_bytes, dm.observations,
            dm.baseline_ratio, dm.threshold)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_writable_store_with_tail_across_packages(ref_art, titles, tmp_path,
                                                  direction):
    """An unsealed tail survives save -> open in the other package, with
    the drift counters and version_id as saved, and the reopened store keeps
    sealing on the same boundaries."""
    store = _mutable(direction, ref_art, titles[:400], drift_threshold=0.07)
    store.extend(titles[400:500])
    store.seal_barrier()
    n_tail = store.stats_snapshot()["n_tail_strings"]
    assert n_tail > 0
    store.version_id = 4  # as after four compactions
    d = str(tmp_path / "wstore")
    store.save(d)
    assert sorted(os.listdir(d)) == ["current.json", "v0004"]
    with open(os.path.join(d, "v0004", "store.json")) as f:
        meta = json.load(f)
    assert meta["encode_backend"] == "numpy" and meta["n_tail"] == n_tail
    re = _open_mutable(direction, d)
    assert re.n_strings == 500 and re.version_id == 4
    assert re.stats_snapshot()["n_tail_strings"] == n_tail
    assert _drift(re) == _drift(store)
    assert re.memory_bytes == store.memory_bytes
    assert re.scan(0, 500) == store.scan(0, 500) == titles[:500]
    ids = np.random.default_rng(2).integers(0, 500, 300).tolist()
    assert re.multiget(ids) == [titles[i] for i in ids]
    # appends seal on the same boundaries in both stores
    assert re.extend(titles[500:900]) == store.extend(titles[500:900])
    re.seal_barrier()
    store.seal_barrier()
    assert [s.base_id for s in re.segments.segments] == \
        [s.base_id for s in store.segments.segments]
    assert re.scan(450, 900) == titles[450:900]
    assert re.compact()["ratio_before"] == store.compact()["ratio_before"]


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_compact_versioned_swap_across_packages(ref_art, titles, tmp_path,
                                                direction):
    """compact(dir_path=) writes v0001/ and the manifest and prunes v0000/;
    the other package's open serves the new generation identically. The
    retrain uses the config saved in the artifact, so a compact in the
    other package after reopening gives the same dictionary."""
    cfg = OnPairConfig.onpair16(sample_bytes=96 << 10, seed=3)
    art = DictArtifact.from_entries("onpair16", ref_art.entries,
                                    config=vars(cfg).copy())
    store = _mutable(direction, art, titles[:600])
    store.extend(titles[600:700])
    d = str(tmp_path / "cstore")
    store.save(d)
    report = store.compact(dir_path=d)
    assert report["version"] == "v0001" and report["dir"] == d
    assert sorted(os.listdir(d)) == ["current.json", "v0001"]
    re = _open_mutable(direction, d)
    assert re.version_id == 1
    n = store.n_strings
    assert re.scan(0, n) == store.scan(0, n) == titles[:700]
    saved = (RefArtifact if direction == "port_to_ref" else DictArtifact).load(
        os.path.join(d, "v0001", "dictionary.rpa"))
    assert saved.config == vars(cfg)
    # both packages retrain the saved generation with the saved config
    back = _open_mutable("ref_to_port" if direction == "port_to_ref"
                         else "port_to_ref", d)
    re.compact()
    back.compact()
    assert re.artifact.entries == back.artifact.entries
    assert re.scan(0, n) == back.scan(0, n) == titles[:700]


def test_flat_store_reopened_writable_compacts_to_versioned(port_art, ref_art,
                                                            titles, tmp_path):
    """A flat read-store directory opens writable; compact() into it leaves
    only the versioned layout, which both packages' opens agree on."""
    flat = CompressedStringStore(port_art, RefEncoder(ref_art).encode(titles[:100]),
                                 device=CPU, strings_per_segment=SPS)
    d = str(tmp_path / "upgrade")
    flat.save(d)
    m = MutableStringStore.open(d, device=CPU)
    m.append(b"appended then compacted")
    report = m.compact()
    assert report["dir"] == d
    assert sorted(os.listdir(d)) == ["current.json", "v0001"]
    assert CompressedStringStore.open(d, device=CPU).n_strings == 101
    assert RefStore.open(d).n_strings == 101
    assert RefMutable.open(d).get(100) == b"appended then compacted"


def test_drift_threshold_survives_save_open(ref_art, titles, tmp_path):
    store = _mutable("port_to_ref", ref_art, titles[:50], drift_threshold=0.05)
    d = str(tmp_path / "thresh")
    store.save(d)
    re = MutableStringStore.open(d, device=CPU)
    assert re.drift.threshold == pytest.approx(0.05)
    # explicit overrides beat the saved params
    re2 = MutableStringStore.open(d, device=CPU, drift_threshold=0.4, train_ratio=9.0)
    assert re2.drift.threshold == pytest.approx(0.4)
    assert re2.drift.baseline_ratio == pytest.approx(9.0)


# ------------------------------------------------------------- index.npz
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_index_sidecar_adopted_across_packages(titles, tmp_path, direction):
    """An index.npz written by either package is adopted by the other (the
    same tables) and answers locate and scan_prefix identically; one that
    does not match the live segmentation is dropped and rebuilt."""
    store = _build_read(direction, titles, strings_per_segment=SPS)
    queries = titles[::97] + [b"@@absent@@", titles[5]]
    want = store.locate_batch(queries)
    assert want == [_first(titles).get(q) for q in queries]
    d = str(tmp_path / "idx")
    store.save(d)
    assert os.path.exists(os.path.join(d, "index.npz"))
    reopened = _open_read(direction, d)
    assert sorted(reopened._seg_indexes) == sorted(store._seg_indexes)
    for k, idx in store._seg_indexes.items():
        got = reopened._seg_indexes[k]
        assert got.n == idx.n
        for field in ("table_fp", "table_loc", "perm"):
            np.testing.assert_array_equal(getattr(got, field), getattr(idx, field))
    assert reopened.locate_batch(queries) == want
    assert reopened.scan_prefix(b"The ", limit=None) == \
        store.scan_prefix(b"The ", limit=None)
    # re-segmented on open: every persisted index mismatches and is dropped
    moved = _open_read(direction, d, strings_per_segment=SPS + 1)
    assert moved._seg_indexes == {}
    assert moved.locate_batch(queries) == want
    # a corrupt sidecar is ignored
    with open(os.path.join(d, "index.npz"), "wb") as f:
        f.write(b"garbage")
    assert _open_read(direction, d)._seg_indexes == {}


# ------------------------------------------------------------- cold tier
def _tiered(store, segments):
    tier = store.enable_tiering(promote_above=1e9)
    for si in segments:
        assert tier.demote(si) is not None
    return tier


def _cold_files(d):
    return sorted(n for n in os.listdir(d) if n.startswith("cold-"))


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_tiered_read_store_opens_across_packages(titles, tmp_path, direction):
    """A read store with cold segments, saved by either package, opens in
    the other with the same cold set and tier_params and serves the same
    bytes, the cold ones from the other package's RLZ files; the port's
    opened store keeps the cold segments off its device mirror; the cold
    files are byte for byte what the other package writes for them."""
    n, cold = 1000, [0, 2, 3, 7]
    store = _build_read(direction, titles[:n], strings_per_segment=128)
    _tiered(store, cold)
    d = str(tmp_path / "tiered")
    store.save(d)
    assert _cold_files(d) == [f"cold-{si:04d}.rlz" for si in cold]
    reopened = _open_read(direction, d)
    assert sorted(reopened.tier.cold) == cold
    assert reopened.tier.params() == store.tier.params()
    with open(os.path.join(d, "store.json")) as f:
        meta = json.load(f)
    assert meta["tier_params"] == store.tier.params()
    assert [c["segment"] for c in meta["cold_segments"]] == cold
    rng = np.random.default_rng(5)
    ids = rng.integers(0, n, 600).tolist()
    assert reopened.multiget(ids) == store.multiget(ids) == [titles[i] for i in ids]
    assert reopened.scan(0, n) == store.scan(0, n) == titles[:n]
    assert reopened.stats.cold_lookups > 0
    assert reopened.memory_bytes == store.memory_bytes
    port = reopened if direction == "ref_to_port" else store
    assert port.resident.n_bytes == sum(
        s.payload_bytes for s in port.segments.segments if s.index not in cold)
    # the other package demotes the same segments to the same files
    d2 = str(tmp_path / "again")
    _tiered(_build_read("port_to_ref" if direction == "ref_to_port" else "ref_to_port",
                        titles[:n], strings_per_segment=128), cold).store.save(d2)
    for name in _cold_files(d):
        h, a = (ref_read_container if direction == "port_to_ref" else read_container)(
            os.path.join(d, name))
        h2, a2 = read_container(os.path.join(d2, name))
        assert h == h2 and set(a) == set(a2)
        for k in a:
            np.testing.assert_array_equal(a[k], a2[k])


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_tiered_writable_store_opens_across_packages(ref_art, titles, tmp_path,
                                                     direction):
    """A writable store with cold segments and an unsealed tail, saved in
    the versioned layout by either package, opens in the other with the
    same cold set (the files copied into ``v0000/``, none left flat) and
    serves the same bytes; it stays writable, and its compact() folds the
    tier back and writes ``v0001/`` without cold files."""
    store = _mutable(direction, ref_art, titles[:600], strings_per_segment=128)
    store.extend(titles[600:650])
    _tiered(store, [1, 4])
    d = str(tmp_path / "wtiered")
    store.save(d)
    assert _cold_files(os.path.join(d, "v0000")) == ["cold-0001.rlz", "cold-0004.rlz"]
    assert _cold_files(d) == []
    reopened = _open_mutable(direction, d)
    assert sorted(reopened.tier.cold) == [1, 4]
    assert reopened.n_strings == 650 and reopened.n_sealed == 600
    assert reopened.scan(0, 650) == store.scan(0, 650) == titles[:650]
    ids = list(range(0, 650, 3))
    assert reopened.multiget(ids) == [titles[i] for i in ids]
    assert reopened.stats.cold_lookups > 0
    assert reopened.extend(titles[650:700]) == list(range(650, 700))
    report = reopened.compact(dir_path=d)
    assert report["version"] == "v0001" and reopened.tier.cold == {}
    assert _cold_files(os.path.join(d, "v0001")) == []
    again = _open_mutable("ref_to_port" if direction == "port_to_ref" else "port_to_ref", d)
    assert again.scan(0, 700) == titles[:700]
    assert again.tier is None


def test_open_without_a_card_raises(tmp_path, port_art, ref_art, titles):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device opens")
    store = CompressedStringStore(port_art, RefEncoder(ref_art).encode(titles[:50]),
                                  device=CPU)
    d = str(tmp_path / "s")
    store.save(d)
    for open_ in (CompressedStringStore.open, MutableStringStore.open):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            open_(d)
