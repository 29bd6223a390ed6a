"""The port's stores over the host codecs (unbounded OnPair and BPE), held
against the JAX package's numpy-backend stores.

The reference trains each codec once per module on the seeded titles (BPE
on a 64 KiB sample) and the port takes the same artifact bytes, so both
packages' stores serve the same corpus. Covered: multiget, get, scan,
``access`` against ``decompress_all`` (the cases of ``tests/test_store.py``),
the stats after the same calls, locate and scan_prefix with pagination,
``build`` by codec name (``tests/test_api_v2.py``), the refusal of codecs
that are not token-stream with the reference's messages, an explicit
``device=`` refused, read, writable and sharded saves that open in either
package, ``extend`` and ``compact`` on the writable store, a demotion and a
promotion, and what is the port's own: such a store builds no device codec,
no device mirror and launches no kernel, and the shards of a sharded store
share one host codec."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import registry as ref_registry
from repro.core.codec import Encoder as RefEncoder
from repro.data.synth import load_dataset as ref_load_dataset
from repro.distributed import ShardedStringStore as RefSharded
from repro.distributed import save_sharded as ref_save_sharded
from repro.store import CompressedStringStore as RefStore
from repro.store import MutableStringStore as RefMutable
from repro_torch.core import DictArtifact, Encoder, registry
from repro_torch.data.synth import load_dataset
from repro_torch.distributed import ShardedStringStore, open_shard, save_sharded
from repro_torch.kernels import onpair_decode, onpair_encode, ops
from repro_torch.store import CompressedStringStore, MutableStringStore

SAMPLE = 1 << 17
SPS = 256
CODECS = ["onpair", "bpe"]
TRAIN = {"onpair": SAMPLE, "bpe": 1 << 16}
COLD = {"promote_above": 1e9}  # keep segments cold under test read loops


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
    strings[100] = b""
    strings[7] = b"\x00\xff" * 9
    strings[11] = bytes(range(256))
    strings[12] = strings[5]            # a duplicate: locate gives the lowest id
    return strings


@pytest.fixture(scope="module")
def arts(titles):
    """codec -> (port artifact, reference artifact): the same bytes."""
    out = {}
    for name in CODECS + ["fsst", "lz-block", "raw"]:
        caps = ref_registry.capabilities(name)
        ra = (ref_registry.train(name, titles, sample_bytes=TRAIN.get(name, 1 << 15))
              if caps.trainable else ref_registry.create(name).to_artifact())
        out[name] = (DictArtifact.from_bytes(ra.to_bytes()), ra)
    return out


def _pair(arts, name, strings, **kw):
    """(port store, reference numpy store) over the same artifact and corpus."""
    kw.setdefault("strings_per_segment", SPS)
    pa, ra = arts[name]
    port = CompressedStringStore(pa, Encoder(pa).encode(strings), **kw)
    want = RefStore(ra, RefEncoder(ra).encode(strings), backend="numpy", **kw)
    return port, want


def _mutable_pair(arts, name, strings, **kw):
    kw.setdefault("strings_per_segment", SPS)
    pa, ra = arts[name]
    port = MutableStringStore(pa, Encoder(pa).encode(strings) if strings else None,
                              **kw)
    want = RefMutable(ra, RefEncoder(ra).encode(strings) if strings else None, **kw)
    return port, want


def _same(port, want, seed=0):
    """Byte for byte: the flat snapshot, a full scan and a multiget."""
    for st in (port, want):
        if hasattr(st, "seal_barrier"):
            st.seal_barrier()
    got, exp = port.snapshot_corpus(), want.snapshot_corpus()
    assert got.payload.tobytes() == exp.payload.tobytes()
    np.testing.assert_array_equal(got.offsets, exp.offsets)
    n = port.n_strings
    assert n == want.n_strings
    live = port.scan(0, n)
    assert live == want.scan(0, n)
    ids = np.random.default_rng(seed).integers(0, n, 300).tolist() + [0, n - 1]
    assert port.multiget(ids) == want.multiget(ids) == [live[i] for i in ids]
    return live


def _junk(n: int, length: int = 40, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, length, dtype=np.uint8).tobytes()
            for _ in range(n)]


@pytest.fixture
def no_device(monkeypatch):
    """Every kernel wrapper and the device codec raise: a host store must
    reach none of them."""
    def boom(*a, **k):
        raise AssertionError("a host-codec store reached the device path")
    for mod, fn in ((onpair_decode, "decode_rows"), (onpair_decode, "decode_tokens"),
                    (onpair_encode, "encode_batch")):
        monkeypatch.setattr(mod, fn, boom)
    monkeypatch.setattr(ops.OnPairDevice, "__init__", boom)


# ------------------------------------------------------------------- reads
@pytest.mark.parametrize("name", CODECS)
def test_reads_match_reference_and_source(arts, titles, name):
    port, want = _pair(arts, name, titles)
    assert port.backend == want.backend == "numpy"
    assert port._device is None and port.resident is None
    assert port.compressor.name == name and port.codec_name == name
    rng = np.random.default_rng(42)
    ids = rng.integers(0, len(titles), 1200).tolist()
    assert port.multiget(ids) == want.multiget(ids) == [titles[i] for i in ids]
    for i in (0, 3, 7, 11, 100, len(titles) - 1):
        assert port.get(i) == titles[i]
    for lo, hi in ((SPS - 20, SPS + 100), (0, len(titles)), (5, 5),
                   (len(titles) - 3, len(titles))):
        assert port.scan(lo, hi) == want.scan(lo, hi) == titles[lo:hi]
    with pytest.raises(IndexError):
        port.multiget([0, len(titles)])
    with pytest.raises(IndexError):
        port.scan(0, len(titles) + 1)


@pytest.mark.parametrize("name", CODECS)
@pytest.mark.parametrize("cache_bytes", [0, 1 << 20])
def test_stats_after_the_same_calls_equal_reference(arts, titles, name,
                                                    cache_bytes):
    port, want = _pair(arts, name, titles, cache_bytes=cache_bytes)
    rng = np.random.default_rng(1)
    for _ in range(5):
        ids = rng.integers(0, len(titles), 400).tolist()
        assert port.multiget(ids) == want.multiget(ids)
    port.scan(10, 600)
    want.scan(10, 600)
    got, exp = port.stats_snapshot(), want.stats_snapshot()
    assert set(got) == set(exp) | {"device_dict_bytes"}
    assert got["device_dict_bytes"] == 0
    for k in ("lookups", "decoded_strings", "decoded_bytes", "scan_strings",
              "batches", "padded_rows", "pad_efficiency", "jit_shapes",
              "backend", "n_strings", "n_segments", "bucket_caps",
              "memory_bytes", "cache"):
        assert got[k] == exp[k], k
    assert port.memory_bytes == want.memory_bytes
    assert port.resident_device_bytes == 0


@pytest.mark.parametrize("name", ["onpair", "onpair16"])
def test_access_equals_decompress_all_slice(arts, titles, name):
    """``tests/test_store.py::test_access_equals_decompress_all_slice`` on
    the port's codecs, unbounded and bounded."""
    comp = registry.create(name, sample_bytes=SAMPLE)
    comp.train(titles)
    corpus = comp.compress(titles[:500])
    blob = comp.decompress_all(corpus)
    lens = comp.dictionary.lens
    starts = np.zeros(corpus.n_strings + 1, dtype=np.int64)
    for i in range(corpus.n_strings):
        toks = np.asarray(corpus.string_tokens(i), dtype=np.int64)
        starts[i + 1] = starts[i] + int(lens[toks].sum())
    assert starts[-1] == len(blob)
    for i in range(corpus.n_strings):
        assert comp.access(corpus, i) == blob[starts[i] : starts[i + 1]]


@pytest.mark.parametrize("name", CODECS)
def test_locate_and_scan_prefix_match_reference(arts, titles, name):
    port, want = _pair(arts, name, titles)
    queries = [titles[i] for i in (0, 3, 5, 12, 11, 700, len(titles) - 1)]
    queries += [b"never stored", b"\x00\xff", titles[9] + b"!"]
    assert port.locate_batch(queries) == want.locate_batch(queries)
    assert port.locate(titles[12]) == want.locate(titles[12]) == 5
    assert port.locate(b"never stored") is want.locate(b"never stored") is None
    for prefix in (b"The ", b"A", b"", b"\x00", b"zzzz"):
        for limit in (None, 7):
            assert port.scan_prefix(prefix, limit) == want.scan_prefix(prefix, limit)
    page = port.scan_prefix(b"The", 10)
    cursor = (page[-1][1], page[-1][0])
    assert port.scan_prefix(b"The", 10, after=cursor) == \
        want.scan_prefix(b"The", 10, after=cursor)
    assert port._query_encoder().backend == "numpy"
    assert port.stats.locates == want.stats.locates


# ------------------------------------------------------ build and refusals
@pytest.mark.parametrize("name", CODECS)
def test_build_by_codec_name_equals_reference(titles, name):
    """``tests/test_api_v2.py::test_store_build_by_codec_name``, with the
    reference's build beside it."""
    port = CompressedStringStore.build(titles, codec=name, sample_bytes=1 << 16,
                                       strings_per_segment=SPS)
    want = RefStore.build(titles, codec=name, sample_bytes=1 << 16,
                          strings_per_segment=SPS)
    assert port.compressor.name == name and port.backend == "numpy"
    assert port.get(3) == titles[3]
    strip = {"train_seconds": 0.0}
    assert dataclasses.replace(port.artifact, stats={**port.artifact.stats, **strip}
                               ).to_bytes() == \
        dataclasses.replace(want.artifact, stats={**want.artifact.stats, **strip}
                            ).to_bytes()
    assert port.corpus.payload.tobytes() == want.corpus.payload.tobytes()


def test_build_variant16_false_is_unbounded_onpair(titles):
    port = CompressedStringStore.build(titles[:800], variant16=False,
                                       sample_bytes=1 << 15)
    assert port.codec_name == "onpair" and port.backend == "numpy"
    assert port.scan(0, 800) == titles[:800]


@pytest.mark.parametrize("name", ["fsst", "lz-block", "raw"])
def test_store_refuses_codecs_that_are_not_token_stream(arts, titles, name):
    """``tests/test_api_v2.py::test_store_rejects_non_token_codec``, with
    the reference's message."""
    pa, ra = arts[name]
    corpus = registry.codec_from_artifact(pa).compress(titles[:50])
    ref_corpus = ref_registry.codec_from_artifact(ra).compress(titles[:50])
    cases = [(lambda: CompressedStringStore(pa, corpus),
              lambda: RefStore(ra, ref_corpus)),
             (lambda: MutableStringStore(pa, corpus),
              lambda: RefMutable(ra, ref_corpus))]
    for port_call, ref_call in cases:
        with pytest.raises(ValueError) as got:
            port_call()
        with pytest.raises(ValueError) as want:
            ref_call()
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="store requires a token-stream codec"):
        CompressedStringStore.build(titles[:50], codec=name)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_explicit_device_for_a_host_codec_raises(arts, titles, tmp_path, device):
    pa, _ = arts["bpe"]
    corpus = Encoder(pa).encode(titles[:300])
    msg = r"is not device-decodable \(registry capability\)"
    with pytest.raises(ValueError, match=msg):
        CompressedStringStore(pa, corpus, device=device)
    with pytest.raises(ValueError, match=msg):
        MutableStringStore(pa, corpus, device=device)
    with pytest.raises(ValueError, match=msg):
        CompressedStringStore.build(titles[:300], codec="bpe", device=device)
    store = CompressedStringStore(pa, corpus, strings_per_segment=64)
    d = str(tmp_path / "s")
    store.save(d)
    with pytest.raises(ValueError, match=msg):
        CompressedStringStore.open(d, device=device)
    save_sharded(store, str(tmp_path / "sh"), 2)
    with pytest.raises(ValueError, match=msg):
        ShardedStringStore.open(str(tmp_path / "sh"), device=device)
    with pytest.raises(ValueError, match=msg):
        open_shard(str(tmp_path / "sh"), 1, device=device)


@pytest.mark.parametrize("name", CODECS)
def test_host_store_reaches_no_kernel_and_no_device_codec(arts, titles, name,
                                                          tmp_path, no_device):
    pa, _ = arts[name]
    store = MutableStringStore(pa, Encoder(pa).encode(titles[:600]),
                               strings_per_segment=128)
    ids = list(range(0, 600, 7))
    assert store.multiget(ids) == [titles[i] for i in ids]
    assert store.scan(0, 600) == titles[:600]
    assert store.locate(titles[300]) == 300
    assert store.scan_prefix(b"The", 5)
    store.extend(titles[600:900])
    store.seal()
    store.enable_tiering(workdir=str(tmp_path / "cold"), **COLD).demote(1)
    assert store.multiget([130, 650]) == [titles[130], titles[650]]
    store.tier.promote(1)
    store.compact(dir_path=str(tmp_path / "w"))
    assert MutableStringStore.open(str(tmp_path / "w")).scan(0, 900) == titles[:900]
    assert store.backend == "numpy" and store.resident is None


# ----------------------------------------------- saves across the packages
@pytest.mark.parametrize("name", CODECS)
@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_read_store_saves_open_in_either_package(arts, titles, name, direction,
                                                 tmp_path):
    port, want = _pair(arts, name, titles, cache_bytes=1 << 16)
    port.locate(titles[40])
    want.locate(titles[40])  # both save an index sidecar
    d = str(tmp_path / "s")
    (port if direction == "port_to_ref" else want).save(d)
    opener = RefStore if direction == "port_to_ref" else CompressedStringStore
    again = opener.open(d)
    assert again.backend == "numpy"
    assert again.scan(0, len(titles)) == titles
    assert again.locate(titles[40]) == 40
    assert again.artifact.to_bytes() == (port if direction == "port_to_ref"
                                         else want).artifact.to_bytes()


@pytest.mark.parametrize("name", CODECS)
@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_writable_saves_open_in_either_package(arts, titles, name, direction,
                                               tmp_path):
    port, want = _mutable_pair(arts, name, titles[:700])
    for st in (port, want):
        st.extend(titles[700:1000])     # crosses a seal, leaves a tail
    _same(port, want)
    d = str(tmp_path / "w")
    (port if direction == "port_to_ref" else want).save(d)
    again = (RefMutable if direction == "port_to_ref" else MutableStringStore).open(d)
    other = MutableStringStore.open(d) if direction == "port_to_ref" else RefMutable.open(d)
    assert again.n_strings == 1000 and again._tail_n() == 1000 - again.n_sealed
    for st in (again, other):
        st.extend([b"after reopen", b""])
    _same(again if direction == "ref_to_port" else other,
          other if direction == "ref_to_port" else again)


@pytest.mark.parametrize("name", CODECS)
def test_writable_extend_and_compact_match_reference(arts, titles, name):
    port, want = _mutable_pair(arts, name, titles[:500], async_seal=False)
    for k in range(0, 900, 300):
        assert port.extend(titles[500 + k : 800 + k]) == \
            want.extend(titles[500 + k : 800 + k])
    port.append(b"one more")
    want.append(b"one more")
    live = _same(port, want)
    assert live == titles[:1400] + [b"one more"]
    port.extend(_junk(200))
    want.extend(_junk(200))
    got, exp = port.compact(), want.compact()
    for k in ("n_strings", "ratio_before", "ratio_after", "version"):
        assert got[k] == exp[k], k
    assert port.artifact.entries == want.artifact.entries
    assert port.compressor.name == name and port.resident is None
    _same(port, want, seed=1)
    port.extend(titles[:50])
    want.extend(titles[:50])
    _same(port, want, seed=2)


@pytest.mark.parametrize("name", CODECS)
def test_demote_and_promote_match_reference(arts, titles, name, tmp_path):
    port, want = _pair(arts, name, titles)
    pt = port.enable_tiering(workdir=str(tmp_path / "p"), **COLD)
    wt = want.enable_tiering(workdir=str(tmp_path / "r"), **COLD)
    for seg in (1, 3):
        got, exp = pt.demote(seg), wt.demote(seg)
        for k in ("segment", "payload_bytes", "rlz_bytes", "raw_bytes"):
            assert got[k] == exp[k], k
        f = f"cold-{seg:04d}.rlz"
        with open(tmp_path / "p" / f, "rb") as a, open(tmp_path / "r" / f, "rb") as b:
            assert a.read() == b.read()
    assert port.memory_bytes == want.memory_bytes
    ids = list(range(SPS - 5, 4 * SPS, 3))
    assert port.multiget(ids) == want.multiget(ids) == [titles[i] for i in ids]
    assert port.scan(0, len(titles)) == titles
    assert port.stats.cold_lookups == want.stats.cold_lookups > 0
    assert port.locate(titles[SPS + 2]) == want.locate(titles[SPS + 2])
    d = str(tmp_path / "saved")
    port.save(d)
    reopened = RefStore.open(d)
    assert sorted(reopened.tier.cold) == [1, 3]
    assert reopened.scan(0, len(titles)) == titles
    assert pt.promote(1) and wt.promote(1)
    assert sorted(pt.cold) == sorted(wt.cold) == [3]
    assert port.multiget(ids) == [titles[i] for i in ids]
    assert port.memory_bytes == want.memory_bytes


# ---------------------------------------------------------------- sharding
@pytest.mark.parametrize("name", CODECS)
def test_sharded_host_store_shares_one_codec(arts, titles, name, tmp_path,
                                             monkeypatch):
    port, want = _pair(arts, name, titles)
    pd, rd = str(tmp_path / "p"), str(tmp_path / "r")
    assert save_sharded(port, pd, 3) == ref_save_sharded(want, rd, 3)
    made = []
    real = registry.codec_from_artifact

    def counting(art):
        made.append(art.codec)
        return real(art)

    monkeypatch.setattr(registry, "codec_from_artifact", counting)
    sharded = ShardedStringStore.open(pd)
    assert made == [name]
    assert len({id(st.compressor) for st in sharded.stores}) == 1
    assert all(st.backend == "numpy" for st in sharded.stores)
    ids = np.random.default_rng(3).integers(0, len(titles), 500).tolist()
    assert sharded.multiget(ids) == [titles[i] for i in ids]
    assert sharded.scan(0, len(titles)) == titles
    assert RefSharded.open(pd).multiget(ids) == [titles[i] for i in ids]
    assert ShardedStringStore.open(rd).scan(0, len(titles)) == titles
    # a save of appends keeps the shared dictionary: the reopen shares too
    w = ShardedStringStore.open(pd, writable=True)
    new = w.extend([b"sharded append", b"another"])
    w.save()
    made.clear()
    again = ShardedStringStore.open(pd, writable=True)
    assert made == [name]
    assert len({id(st.compressor) for st in again.stores}) == 1
    assert again.multiget(new) == [b"sharded append", b"another"]
    assert RefSharded.open(pd).multiget(new) == [b"sharded append", b"another"]
