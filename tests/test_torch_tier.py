"""The cold tier on the port's stores, held against the JAX package's.

Port stores run on ``device="cpu"`` (the kernels' plain versions) and the
reference's on its numpy backend, over the same seeded titles, the same
artifact and the same calls. Covered: the RLZ codec (the port's factor
arrays equal the reference's, array for array), a demoted store's reads
byte for byte (multiget, get, scan, locate, scan_prefix), memory_bytes
after demotion, save/open with cold files, promotion (explicit, by a read
burst, after ``tick``'s off-thread demotions), compact() folding the tier
back, the writable store's save/open with a cold tier and a tail, the
read-rate EWMA, ``tier_op``, the async-seal cases, a saved store whose
cold file is cut short or has a garbage header (both packages open it with
that segment hot), and what is the port's
own: the device mirror after evict/restore, scans that split at cold
segments, the tier snapshot, and the RLZ reference over bare device
tables."""

import os
import threading

import numpy as np
import pytest
import torch

from repro.core import registry
from repro.core.codec import Encoder as RefEncoder
from repro.core.rlz import RLZCodec as RefRLZ
from repro.data.synth import load_dataset as ref_load_dataset
from repro.store import CompressedStringStore as RefStore
from repro.store import DriftMonitor as RefDrift
from repro.store import MutableStringStore as RefMutable
from repro.store import tier_op as ref_tier_op
from repro.store.drift import segment_report as ref_segment_report
from repro_torch import convert
from repro_torch.core import DictArtifact, Encoder
from repro_torch.core.artifact import MAGIC, read_container
from repro_torch.core.packed import PackedDictionary
from repro_torch.core.rlz import RLZCodec, decode_ids, decode_range, rlz_nbytes
from repro_torch.data.synth import load_dataset
from repro_torch.kernels import ref
from repro_torch.kernels.ops import OnPairDevice
from repro_torch.obs import REGISTRY, Gauge
from repro_torch.store import (CompressedStringStore, DriftMonitor,
                               MutableStringStore, tier_op)
from repro_torch.store.drift import segment_report

SAMPLE = 1 << 18
SPS = 128  # small segments so a corpus spans many demotion candidates
COLD = {"promote_above": 1e9}  # keep segments cold under test read loops
CPU = torch.device("cpu")


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
    return strings


@pytest.fixture(scope="module")
def ref_art(titles):
    return registry.train("onpair16", titles, sample_bytes=SAMPLE)


@pytest.fixture(scope="module")
def port_art(ref_art):
    return DictArtifact.from_bytes(ref_art.to_bytes())


def _pair(port_art, ref_art, strings, **kw):
    """(port store, reference store) over the same artifact and corpus."""
    kw.setdefault("strings_per_segment", SPS)
    port = CompressedStringStore(port_art, Encoder(port_art, device=CPU).encode(strings),
                                 device=CPU, **kw)
    want = RefStore(ref_art, RefEncoder(ref_art).encode(strings), backend="numpy", **kw)
    return port, want


def _mutable_pair(port_art, ref_art, strings, **kw):
    kw.setdefault("strings_per_segment", SPS)
    corpus = Encoder(port_art, device=CPU).encode(strings) if strings else None
    port = MutableStringStore(port_art, corpus, device=CPU, **kw)
    ref_corpus = RefEncoder(ref_art).encode(strings) if strings else None
    return port, RefMutable(ref_art, ref_corpus, **kw)


def _demote_all(store, **params):
    tier = store.enable_tiering(**{**COLD, **params})
    for seg in store.segments.segments:
        tier.demote(seg.index)
    return tier


def _reads(store, n):
    """The reference test's reads: a multiget, five gets, two scans."""
    ids = np.random.default_rng(7).integers(0, n, 200).tolist()
    return ([store.multiget(ids)]
            + [store.get(i) for i in (0, 3, 7, n // 2, n - 1)]
            + [store.scan(0, n), store.scan(SPS - 3, SPS + 3)])


def _assert_reads_identical(store, titles, n, want=None):
    """The reads each == the source and, with ``want`` (the reference's
    store in the same state), == its answers to the same calls."""
    ids = np.random.default_rng(7).integers(0, n, 200).tolist()
    got = _reads(store, n)
    assert got == ([[titles[i] for i in ids]]
                   + [titles[i] for i in (0, 3, 7, n // 2, n - 1)]
                   + [titles[:n], titles[SPS - 3:SPS + 3]])
    if want is not None:
        assert _reads(want, n) == got


def _mirror(store):
    """The mirror's payload and starts on its device, as host arrays."""
    tokens, starts = store.resident.on_device()
    return tokens.view(torch.uint8).numpy().copy(), starts.numpy().copy()


def _hot_payload_bytes(store):
    cold = store.tier.cold if store.tier is not None else {}
    return sum(s.payload_bytes for s in store.segments.segments
               if s.index not in cold)


# ------------------------------------------------------------- RLZ codec
def _rlz_case(name, titles):
    """(reference bytes, codec kwargs, strings) of each case of the
    reference's RLZ tests."""
    if name == "roundtrip":
        return (b"".join(titles[:50]), {},
                titles[50:250] + [b"", b"\x00" * 3, titles[60], titles[60]])
    if name == "literals_only":
        rng = np.random.default_rng(0)
        return (b"aaaaaaaaaaaaaaaa", {"min_match": 8},
                [rng.integers(0, 256, 40, dtype=np.uint8).tobytes()
                 for _ in range(20)])
    if name == "redundant":
        return b"".join(titles[:200]), {}, titles[:200]
    return b"abcdefgh" * 4, {}, []


@pytest.mark.parametrize("case", ["roundtrip", "literals_only", "redundant", "empty"])
def test_rlz_factor_arrays_equal_reference(titles, case):
    """The port's factorization equals the reference's array for array (a
    cold file written by one package is read by the other), and round-trips."""
    reference, kw, strings = _rlz_case(case, titles)
    arrays = RLZCodec(reference, **kw).factorize(strings)
    want = RefRLZ(reference, **kw).factorize(strings)
    assert set(arrays) == set(want) == {"starts", "offs", "lens", "literals"}
    for k in want:
        assert arrays[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(arrays[k], want[k])
    assert decode_ids(reference, arrays, range(len(strings))) == strings
    assert rlz_nbytes(arrays) == sum(a.nbytes for a in want.values())
    if case == "roundtrip":
        assert decode_ids(reference, arrays, [203, 0, 17]) == [
            strings[203], strings[0], strings[17]]
        assert decode_range(reference, arrays, 5, 9) == strings[5:9]
        assert arrays["starts"].shape == (len(strings) + 1,)
    elif case == "literals_only":
        assert arrays["literals"].size >= sum(map(len, strings)) * 0.9
    elif case == "redundant":
        assert rlz_nbytes(arrays) < sum(map(len, strings))
    else:
        assert decode_ids(reference, arrays, []) == []
    with pytest.raises(ValueError):
        RLZCodec(reference, min_match=3)


# ---------------------------------------------- byte-identity hot vs cold
def test_demoted_store_reads_byte_identical(port_art, ref_art, titles):
    n = 1000
    store, want = _pair(port_art, ref_art, titles[:n])
    tier = _demote_all(store)
    _demote_all(want)
    assert len(tier.cold) == store.segments.n_segments == len(want.tier.cold)
    _assert_reads_identical(store, titles, n, want)
    assert store.stats.cold_lookups == want.stats.cold_lookups > 0
    # cached entries short-circuit before the tier split
    hits0 = store.cache.hits
    cold0 = store.stats.cold_lookups
    for st in (store, want):
        st.multiget([0, 1, 2])
        st.multiget([0, 1, 2])
    assert store.cache.hits > hits0
    assert store.stats.cold_lookups <= cold0 + 3
    assert store.stats.cold_lookups == want.stats.cold_lookups
    assert store.cache.hits == want.cache.hits


def test_locate_and_scan_prefix_on_cold_segments(port_art, ref_art, titles):
    n = 600
    store, want = _pair(port_art, ref_art, titles[:n])
    hot_locate = [store.locate(titles[i]) for i in range(0, n, 13)]
    prefix = titles[5][:4]
    hot_prefix = store.scan_prefix(prefix, limit=None)
    _demote_all(store)
    _demote_all(want)
    got = [store.locate(titles[i]) for i in range(0, n, 13)]
    assert got == hot_locate == [want.locate(titles[i]) for i in range(0, n, 13)]
    assert store.locate(b"@@definitely-absent@@") is None
    assert store.scan_prefix(prefix, limit=None) == hot_prefix == \
        want.scan_prefix(prefix, limit=None)
    # the index fingerprints the mapped OnPair payload of each cold segment
    assert all(isinstance(s.payload, np.memmap) for s in store.segments.segments)


def test_memory_drops_at_least_40pct_when_majority_cold(port_art, ref_art, titles):
    # payload-dominated corpus: enough strings that segment bytes dwarf the
    # dictionary's fixed resident cost, as the reference's test requires
    corpus = (titles * 6)[:24_000]
    n = len(corpus)
    store, want = _pair(port_art, ref_art, corpus, cache_bytes=0)
    before = store.memory_bytes
    assert before == want.memory_bytes
    device_before = store.resident_device_bytes
    tier = _demote_all(store)
    _demote_all(want)
    assert len(tier.cold) >= store.segments.n_segments // 2  # majority cold
    after = store.memory_bytes
    assert after == want.memory_bytes
    assert after <= before * 0.6, (before, after)
    # every segment's tokens left the device mirror
    assert store.resident.n_bytes == 0
    assert store.resident_device_bytes == device_before - store.segments.payload_bytes
    _assert_reads_identical(store, corpus, n, want)


def test_save_open_preserves_cold_tier(port_art, ref_art, titles, tmp_path):
    n = 800
    store, _ = _pair(port_art, ref_art, titles[:n])
    _demote_all(store)
    d = str(tmp_path / "cold")
    store.save(d)
    names = os.listdir(d)
    assert any(f.startswith("cold-") and f.endswith(".rlz") for f in names)

    re = CompressedStringStore.open(d, device=CPU)
    assert re.tier is not None and sorted(re.tier.cold) == sorted(store.tier.cold)
    assert re.tier.promote_above == pytest.approx(COLD["promote_above"])
    assert re.resident.n_bytes == 0 and re.memory_bytes == store.memory_bytes
    _assert_reads_identical(re, titles, n)
    re.cache.clear()
    re.multiget(list(range(0, n, 5)))
    assert re.stats.cold_lookups > 0


def test_save_without_tier_writes_no_cold_files(port_art, ref_art, titles, tmp_path):
    store, _ = _pair(port_art, ref_art, titles[:300])
    d = str(tmp_path / "plain")
    store.save(d)
    assert not any(f.startswith("cold-") for f in os.listdir(d))
    re = CompressedStringStore.open(d, device=CPU)
    assert re.tier is None
    assert tier_op(re, "stats") == {"enabled": False} == ref_tier_op(
        RefStore.open(d), "stats")


def test_promote_restores_heap_arrays(port_art, ref_art, titles):
    n = 500
    store, want = _pair(port_art, ref_art, titles[:n])
    tier = _demote_all(store)
    _demote_all(want)
    seg0 = store.segments.segments[0]
    assert isinstance(seg0.payload, np.memmap)
    assert tier.promote(0) and not tier.promote(0)  # second is a no-op
    assert want.tier.promote(0)
    assert 0 not in tier.cold
    assert not isinstance(store.segments.segments[0].payload, np.memmap)
    assert tier.promotions == 1
    assert _hot_payload_bytes(store) == store.resident.n_bytes > 0
    _assert_reads_identical(store, titles, n, want)
    snap = store.stats_snapshot()["tier"]
    assert snap["n_cold"] == len(tier.cold)
    assert snap["demotions"] == tier.demotions and snap["promotions"] == 1


def test_read_burst_promotes_cold_segment(port_art, ref_art, titles):
    store, want = _pair(port_art, ref_art, titles[:500])
    for st in (store, want):
        tier = st.enable_tiering(promote_above=0.001, halflife_s=30.0)
        assert tier.demote(0) is not None
        for _ in range(3):
            st.multiget(list(range(0, SPS)))
        assert 0 not in tier.cold and tier.promotions >= 1
    assert store.tier.promotions == want.tier.promotions
    assert store.stats.cold_lookups == want.stats.cold_lookups
    assert _hot_payload_bytes(store) == store.resident.n_bytes


def test_tick_demotes_idle_segments_off_thread(port_art, ref_art, titles):
    store, want = _pair(port_art, ref_art, titles[:500])
    tier = store.enable_tiering(demote_below=0.05, **COLD)
    scheduled = tier.tick()
    tier.join()
    assert scheduled and len(tier.cold) == len(scheduled)
    worker = tier._worker
    assert worker is not None and worker.daemon
    wtier = want.enable_tiering(demote_below=0.05, **COLD)
    assert wtier.tick() == scheduled
    wtier.join()
    assert sorted(tier.cold) == sorted(wtier.cold)
    _assert_reads_identical(store, titles, 500, want)


def test_compact_folds_cold_tier_back_hot(port_art, ref_art, titles):
    store, want = _mutable_pair(port_art, ref_art, titles[:400])
    for st in (store, want):
        _demote_all(st)
        assert len(st.tier.cold) > 0
        st.compact()
        assert st.tier.cold == {}  # rewrite folded everything back in
        assert st.scan(0, 400) == titles[:400]
        assert not isinstance(st.segments.segments[0].payload, np.memmap)
    # the mirror holds every segment of the new generation
    assert store.resident.n_bytes == store.segments.payload_bytes
    assert store.memory_bytes == want.memory_bytes


def test_mutable_save_open_roundtrip_with_cold_tail(port_art, ref_art, titles,
                                                    tmp_path):
    store, _ = _mutable_pair(port_art, ref_art, titles[:300])
    store.extend(titles[300:350])                 # unsealed tail stays hot
    _demote_all(store)
    d = str(tmp_path / "mcold")
    store.save(d)
    re = MutableStringStore.open(d, device=CPU)
    assert re.tier is not None and sorted(re.tier.cold) == sorted(store.tier.cold)
    assert re.resident.n_bytes == 0
    assert re.scan(0, 350) == titles[:350]
    ids = re.extend(titles[350:400])              # still writable
    assert ids == list(range(350, 400))
    assert re.get(399) == titles[399]


# ------------------------------------------------ a damaged cold file
def _cold_header_end(path: str) -> int:
    """Bytes of a cold container up to the end of its JSON header."""
    with open(path, "rb") as f:
        head = f.read(len(MAGIC) + 8)
    return len(MAGIC) + 8 + int(np.frombuffer(head[len(MAGIC) + 4:], "<u4")[0])


def _damages(path: str):
    """(label, bytes) of every damaged copy of the container at ``path``:
    cut at every length from 0 to past its header, or a header of garbage
    after the magic."""
    blob = open(path, "rb").read()
    end = _cold_header_end(path)
    for n in range(0, end + 24):
        yield f"cut at {n} B", blob[:n]
    hlen = np.frombuffer(blob[len(MAGIC) + 4:len(MAGIC) + 8], "<u4")
    garbage = bytes(np.random.default_rng(3).integers(0, 256, int(hlen[0]),
                                                      dtype=np.uint8))
    yield "garbage header", blob[:len(MAGIC) + 8] + garbage + blob[end:]
    yield "huge header length", (blob[:len(MAGIC) + 4]
                                 + np.uint32(2**31).tobytes() + blob[len(MAGIC) + 8:])


def test_damaged_cold_file_opens_hot_in_both_packages(port_art, ref_art, titles,
                                                      tmp_path):
    """A saved store whose cold container cannot be read opens with that
    segment hot, in either package, and serves the same bytes: the
    contract the index sidecar has."""
    n = 600
    store, _ = _pair(port_art, ref_art, titles[:n])
    store.enable_tiering(**COLD).demote(1)
    d = str(tmp_path / "damaged")
    store.save(d)
    cold = os.path.join(d, "cold-0001.rlz")
    assert os.path.exists(cold)
    # every cut goes through the open path that re-adopts the cold set
    # (open_corpus_dir), against sources loaded once
    art = DictArtifact.load(os.path.join(d, "dictionary.rpa"))
    port_src = OnPairDevice(art, CPU)
    ref_src = (ref_art, registry.codec_from_artifact(ref_art))
    seg1 = list(range(SPS - 2, 2 * SPS + 2))
    for label, data in _damages(cold):
        with open(cold, "wb") as f:
            f.write(data)
        got = CompressedStringStore.open_corpus_dir(d, port_src, device=CPU)
        want = RefStore.open_corpus_dir(d, ref_src, backend="numpy")
        assert got.tier.cold == {} and want.tier.cold == {}, label
        assert got.resident.n_bytes == got.segments.payload_bytes, label
        assert got.multiget(seg1) == want.multiget(seg1) == \
            [titles[i] for i in seg1], label
        if label in ("cut at 0 B", "cut at 10 B", "garbage header"):
            # the whole open of either package, and the full reads
            full = CompressedStringStore.open(d, device=CPU)
            ref_full = RefStore.open(d, backend="numpy")
            assert full.tier.cold == {} and ref_full.tier.cold == {}, label
            assert full.scan(0, n) == ref_full.scan(0, n) == titles[:n], label


def test_damaged_cold_file_opens_hot_in_both_writable_stores(port_art, ref_art,
                                                             titles, tmp_path):
    store, _ = _mutable_pair(port_art, ref_art, titles[:300])
    store.extend(titles[300:350])                 # an unsealed tail too
    store.enable_tiering(**COLD).demote(1)
    d = str(tmp_path / "mdamaged")
    store.save(d)
    cold = os.path.join(d, "v0000", "cold-0001.rlz")
    end = _cold_header_end(cold)
    for label, data in _damages(cold):
        if label.startswith("cut at ") and int(label.split()[2]) not in (
                0, 8, 10, 12, end - 1, end, end + 8):
            continue
        with open(cold, "wb") as f:
            f.write(data)
        got = MutableStringStore.open(d, device=CPU)
        want = RefMutable.open(d, backend="numpy")
        assert got.tier.cold == {} and want.tier.cold == {}, label
        assert got.scan(0, 350) == want.scan(0, 350) == titles[:350], label
        assert got.extend(titles[350:360]) == want.extend(titles[350:360]), label
        assert got.multiget(list(range(340, 360))) == titles[340:360], label


# ---------------------------------------------------- temperature (EWMA)
@pytest.mark.parametrize("monitor", ["port", "reference"])
def test_read_rate_ewma_decays_with_halflife(monitor):
    """The reference's case, on the port's monitor and on the reference's,
    with the same rates."""
    cls = DriftMonitor if monitor == "port" else RefDrift
    m = cls(read_halflife_s=10.0)
    m.note_reads({0: 100}, now=0.0)
    r0 = m.read_rate(0, now=0.0)
    assert r0 > 0
    # one halflife later the decayed mass (and rate) halves
    m.note_reads({0: 0}, now=10.0)
    assert m.read_rate(0, now=10.0) == pytest.approx(r0 / 2)
    # unknown segment reads as stone cold
    assert m.read_rate(99, now=10.0) == 0.0
    assert set(m.read_rates(now=10.0)) == {0}
    other = (RefDrift if monitor == "port" else DriftMonitor)(read_halflife_s=10.0)
    other.note_reads({0: 100}, now=0.0)
    other.note_reads({0: 0}, now=10.0)
    assert m.read_rates(now=13.0) == other.read_rates(now=13.0)
    m.reset()
    assert m.read_rates() == {}


def test_read_rate_accumulates_sustained_traffic():
    m, want = DriftMonitor(read_halflife_s=5.0), RefDrift(read_halflife_s=5.0)
    for t in range(10):
        m.note_reads({0: 50, 1: 1}, now=float(t))
        want.note_reads({0: 50, 1: 1}, now=float(t))
    assert m.read_rate(0, now=9.0) > m.read_rate(1, now=9.0) > 0
    assert m.read_rates(now=9.5) == want.read_rates(now=9.5)


# ----------------------------------------------------------- tier_op API
@pytest.mark.parametrize("scope", ["all", "one"])
def test_tier_op_demote_promote(port_art, ref_art, titles, scope):
    """``tier_op`` on every segment and on one, with the reference's
    answers for the same calls."""
    store, want = _pair(port_art, ref_art, titles[:500])
    if scope == "one":
        for op in (tier_op, ref_tier_op):
            st = store if op is tier_op else want
            r = op(st, "demote", segment=1, params=COLD)
            assert r["demoted"] == [1] and r["n_cold"] == 1
            assert op(st, "promote", segment=1)["promoted"] == [1]
        return
    r = tier_op(store, "demote", params=COLD)
    assert r == ref_tier_op(want, "demote", params=COLD)
    assert r["enabled"] and r["n_cold"] == len(r["demoted"]) > 0
    again = tier_op(store, "demote", params=COLD)
    assert again["demoted"] == []                 # idempotent
    stats = tier_op(store, "stats")
    assert stats["enabled"] and stats["n_cold"] == r["n_cold"]
    assert stats["rlz_bytes"] == ref_tier_op(want, "stats")["rlz_bytes"] > 0
    p = tier_op(store, "promote")
    assert sorted(p["promoted"]) == sorted(r["demoted"])
    assert p["n_cold"] == 0
    with pytest.raises(ValueError):
        tier_op(store, "defrost")


# ----------------------------------------------------- async tail seals
def test_async_seal_commits_off_thread(port_art, ref_art, titles):
    store, _ = _mutable_pair(port_art, ref_art, titles[:SPS])
    assert store.async_seal
    store.extend(titles[SPS:SPS * 3 + 10])
    store.seal_barrier()
    assert store.segments.n_segments == 3
    assert store.stats_snapshot()["n_tail_strings"] == 10
    assert store.scan(0, SPS * 3 + 10) == titles[:SPS * 3 + 10]


def test_sync_seal_mode_still_available(port_art, ref_art, titles):
    store, _ = _mutable_pair(port_art, ref_art, [], async_seal=False)
    store.extend(titles[:SPS * 2 + 5])
    # no barrier needed: seals happened inline during extend
    assert store.segments.n_segments == 2
    assert store.scan(0, SPS * 2 + 5) == titles[:SPS * 2 + 5]


def test_async_seal_flag_survives_save_open(port_art, ref_art, titles, tmp_path):
    store, _ = _mutable_pair(port_art, ref_art, [], async_seal=False)
    store.extend(titles[:100])
    d = str(tmp_path / "sync")
    store.save(d)
    assert MutableStringStore.open(d, device=CPU).async_seal is False
    assert RefMutable.open(d).async_seal is False


def test_save_during_pending_seal_waits_for_commit(port_art, ref_art, titles,
                                                   tmp_path):
    store, _ = _mutable_pair(port_art, ref_art, [])
    store.extend(titles[:SPS * 2])
    d = str(tmp_path / "pend")
    store.save(d)                                 # joins the pending seal
    re = MutableStringStore.open(d, device=CPU)
    assert re.scan(0, SPS * 2) == titles[:SPS * 2]


def test_concurrent_readers_during_async_seals(port_art, ref_art, titles):
    store, _ = _mutable_pair(port_art, ref_art, [])
    store.extend(titles[:50])
    errors = []

    def reader():
        try:
            for _ in range(200):
                n = store.n_strings
                got = store.multiget([0, n - 1])
                assert got[0] == titles[0]
        except Exception as e:  # failure reporting
            errors.append(e)

    t = threading.Thread(target=reader)
    t.start()
    for lo in range(50, SPS * 4, 50):
        store.extend(titles[lo:lo + 50])
    t.join(timeout=60)
    assert not t.is_alive()
    store.seal_barrier()
    assert not errors
    assert store.scan(0, SPS * 4) == titles[:SPS * 4]


# ------------------------------------------------- the port's own cases
def test_mirror_after_evict_restore_equals_untiered(port_art, ref_art, titles):
    """With k segments cold the mirror holds exactly the hot segments'
    payload; after every one came back its payload and starts are those of
    a store never tiered, byte for byte; a failed evict or restore raises
    and changes nothing."""
    n = 1000
    store, _ = _pair(port_art, ref_art, titles[:n])
    fresh, _ = _pair(port_art, ref_art, titles[:n])
    pay0, starts0 = _mirror(fresh)
    tier = store.enable_tiering(**COLD)
    for si in (3, 0, 7, 5):                       # last segment is short
        tier.demote(si)
        assert store.resident.n_bytes == _hot_payload_bytes(store)
        assert store.resident_device_bytes == store.resident.n_bytes + starts0.nbytes
        # evicted strings keep empty ranges, hot ones their tokens
        seg = store.segments.segments[si]
        ids = np.arange(seg.base_id, seg.base_id + seg.n_strings)
        assert not store.resident.token_counts(ids).any()
    hot = [s for s in store.segments.segments if s.index not in tier.cold]
    pay, starts = _mirror(store)
    assert pay.tobytes() == b"".join(np.asarray(s.payload).tobytes() for s in hot)
    res = store.resident
    with pytest.raises(ValueError):
        res.evict(0, 10)                          # inside an evicted range
    with pytest.raises(ValueError):               # not evicted
        res.restore(SPS, 2 * SPS, hot[0].payload, hot[0].offsets)
    seg = store.segments.segments[3]
    with pytest.raises(ValueError):               # another segment's payload
        res.restore(seg.base_id, seg.base_id + seg.n_strings, hot[1].payload,
                    hot[1].offsets)
    with pytest.raises(ValueError):
        res.restore(seg.base_id, seg.base_id + seg.n_strings - 1, seg.payload,
                    seg.offsets[:-1])
    after = _mirror(store)
    assert after[0].tobytes() == pay.tobytes() and np.array_equal(after[1], starts)
    for si in (5, 3, 7, 0):
        assert tier.promote(si)
    pay1, starts1 = _mirror(store)
    assert pay1.tobytes() == pay0.tobytes()
    np.testing.assert_array_equal(starts1, starts0)
    np.testing.assert_array_equal(store.resident.raw_lens, fresh.resident.raw_lens)
    assert store.resident_device_bytes == fresh.resident_device_bytes
    assert store.resident.evicted == {}


SCAN_RANGES = [(0, 1000), (0, SPS), (SPS - 3, SPS + 3), (10, 20), (130, 140),
               (3 * SPS + 5, 5 * SPS + 7), (2 * SPS, 4 * SPS), (5, 7 * SPS + 1),
               (7 * SPS + 1, 1000), (999, 1000), (500, 500)]


@pytest.fixture(scope="module")
def tiered_pair(port_art, ref_art, titles):
    """Port and reference stores of 1,000 strings with segments 0, 2, 3, 5
    and the short last one (7) cold."""
    pair = _pair(port_art, ref_art, titles[:1000], cache_bytes=0)
    for st in pair:
        tier = st.enable_tiering(**COLD)
        for si in (0, 2, 3, 5, 7):
            tier.demote(si)
    return pair


@pytest.mark.parametrize("lo,hi", SCAN_RANGES)
def test_scans_split_at_cold_segments(tiered_pair, titles, lo, hi):
    """Ranges that start, end and straddle inside cold segments read the
    source, in one stream call per run of hot segments, and equal the
    reference's."""
    store, want = tiered_pair
    cold = store.tier.cold
    segs = sorted({i // SPS for i in range(lo, hi)})
    runs = sum(k not in cold and (j == 0 or segs[j - 1] in cold)
               for j, k in enumerate(segs))
    before = ref.decode_tokens_ref.calls
    got = store.scan(lo, hi)
    assert got == titles[lo:hi] == want.scan(lo, hi)
    assert ref.decode_tokens_ref.calls - before == runs


def test_hot_misses_keep_their_one_launch(port_art, ref_art, titles):
    """A multiget's cold misses decode from RLZ on the host and count in
    cold_lookups; its hot misses still go to the decode kernel's wrapper in
    one call, and a cold-only multiget calls it not at all."""
    store, want = _pair(port_art, ref_art, titles[:1000], cache_bytes=0)
    for st in (store, want):
        tier = st.enable_tiering(**COLD)
        for si in (1, 4):
            tier.demote(si)
    rng = np.random.default_rng(3)
    for ids, calls in ((rng.integers(0, 1000, 300), 1),
                       (np.arange(SPS, 2 * SPS), 0),
                       (np.concatenate([np.arange(4 * SPS, 5 * SPS), [SPS]]), 0),
                       (np.arange(2 * SPS, 3 * SPS), 1)):
        before = ref.decode_rows_ref.calls
        assert store.multiget(ids) == [titles[i] for i in ids] == want.multiget(ids)
        assert ref.decode_rows_ref.calls - before == calls
        assert store.stats.cold_lookups == want.stats.cold_lookups
    snap, ref_snap = store.stats_snapshot(), want.stats_snapshot()
    for key in ("lookups", "decoded_strings", "decoded_bytes", "cold_lookups",
                "memory_bytes"):
        assert snap[key] == ref_snap[key], key


def test_tier_snapshot_matches_reference(port_art, ref_art, titles):
    """``stats_snapshot()["tier"]`` has the reference's keys and, after the
    same demotions, promotions and reads, the same values but for the
    latencies and the rates' values; the tier gauges read the same bytes."""
    store, want = _pair(port_art, ref_art, titles[:1000])
    for st in (store, want):
        tier = st.enable_tiering(**COLD)
        for si in (0, 2, 6):
            tier.demote(si)
        tier.promote(2)
        st.multiget(list(range(0, 1000, 7)))
    snap, ref_snap = store.stats_snapshot()["tier"], want.stats_snapshot()["tier"]
    assert set(snap) == set(ref_snap)
    for key in set(snap) - {"cold_latency", "read_rates"}:
        assert snap[key] == ref_snap[key], key
    assert set(snap["cold_latency"]) == set(ref_snap["cold_latency"])
    assert set(snap["read_rates"]) == set(ref_snap["read_rates"])
    with store._lock:
        hot, cold = store.tier.hot_bytes_locked(), store.tier.cold_bytes_locked()
    with want._lock:
        assert (hot, cold) == (want.tier.hot_bytes_locked(),
                               want.tier.cold_bytes_locked())
    assert REGISTRY.gauge("repro_store_tier_bytes", tier="hot") is store.tier._gauge_hot


def test_gauge_and_get_or_create():
    g = REGISTRY.gauge("repro_test_gauge", which="a")
    assert isinstance(g, Gauge) and g.kind == "gauge"
    assert REGISTRY.gauge("repro_test_gauge", which="a") is g
    g.set(3)
    assert g.state() == {"value": 3.0}
    series = [m for m in REGISTRY.snapshot()["metrics"] if m["name"] == "repro_test_gauge"]
    assert series == [{"type": "gauge", "name": "repro_test_gauge",
                       "labels": {"which": "a"}, "value": 3.0}]
    h = REGISTRY.histogram("repro_test_hist_us", bounds=(1.0, 2.0))
    assert REGISTRY.histogram("repro_test_hist_us") is h and h.bounds == (1.0, 2.0)
    with pytest.raises(TypeError):
        REGISTRY.histogram("repro_test_gauge", which="a")


def test_segment_routing_and_report_equal_reference(port_art, ref_art, titles):
    """``route``/``overlapping`` and the per-segment ratio report answer as
    the reference's, over a writable store with sealed tails."""
    store, want = _mutable_pair(port_art, ref_art, titles[:300],
                                async_seal=False)
    for st in (store, want):
        st.extend(titles[300:700])
    segs, ref_segs = store.segments, want.segments
    assert segs._base_ids == ref_segs._base_ids
    for gid in (0, 127, 128, 299, 300, 427, 428, segs.n_strings - 1):
        seg, local = segs.route(gid)
        rseg, rlocal = ref_segs.route(gid)
        assert (seg.index, local) == (rseg.index, rlocal)
    with pytest.raises(IndexError):
        segs.route(segs.n_strings)
    for lo, hi in ((0, 1), (100, 400), (250, 260), (5, 5)):
        assert [s.index for s in segs.overlapping(lo, hi)] == \
            [s.index for s in ref_segs.overlapping(lo, hi)]
    assert segment_report(store) == ref_segment_report(want)


def test_rlz_reference_over_device_tables_equals_blob(ref_art, titles, tmp_path):
    """A store over ``convert``-ed device tables (no host dictionary) builds
    its RLZ reference from them, byte-identical to the reference's
    ``dictionary.blob``: the same ref_crc and the same cold file arrays, so
    the reference opens its tiered save."""
    d = PackedDictionary.build(ref_art.entries)
    dd = convert.dictionary_from_reference(
        {k: getattr(d, k) for k in ref.ARRAY_FIELDS}, d.s_probe_max,
        d.p_probe_max, max(1, d.max_bucket_size), device="cpu")
    ref_corpus = RefEncoder(ref_art).encode(titles[:600])
    corpus = convert.corpus_from_reference(ref_corpus.payload, ref_corpus.offsets,
                                           ref_corpus.raw_bytes)
    store = CompressedStringStore(dd, corpus, device=CPU, strings_per_segment=SPS)
    want = RefStore(ref_art, ref_corpus, backend="numpy", strings_per_segment=SPS)
    assert store._device.dictionary is None
    assert store._device.blob.tobytes() == np.asarray(want.dictionary.blob).tobytes()
    for st, sub in ((store, "port"), (want, "ref")):
        st.enable_tiering(workdir=str(tmp_path / sub), **COLD).demote(2)
    (h, a), (rh, ra) = (read_container(str(tmp_path / sub / "cold-0002.rlz"))
                        for sub in ("port", "ref"))
    assert h == rh
    for k in ra:
        np.testing.assert_array_equal(a[k], ra[k])
    d2 = str(tmp_path / "saved")
    store.save(d2)
    opened = RefStore.open(d2)
    assert sorted(opened.tier.cold) == [2]
    assert opened.scan(0, 600) == titles[:600]


# ------------------------------- a sharded demotion with no workdir
def test_sharded_demotion_without_workdir_writes_under_the_shard_dirs(
        port_art, ref_art, titles, tmp_path, monkeypatch):
    """A shard opened from disk keeps its cold files beside its own files
    (the current generation's directory of a writable one), where a save
    lists them and either package's open attaches them; no temporary
    directory is made."""
    from repro.distributed import ShardedStringStore as RefSharded
    from repro_torch.distributed import ShardedStringStore, save_sharded
    import tempfile

    def no_tempdir(*a, **k):
        raise AssertionError("a shard opened from disk made a temp directory")

    monkeypatch.setattr(tempfile, "mkdtemp", no_tempdir)
    port, _ = _pair(port_art, ref_art, titles[:1200])
    d = str(tmp_path / "shards")
    save_sharded(port, d, 2)
    ro = ShardedStringStore.open(d, device=CPU)
    ro.demote(shard=0, segment=1, **COLD)
    assert os.path.exists(os.path.join(d, "shard-0000", "cold-0001.rlz"))
    w = ShardedStringStore.open(d, device=CPU, writable=True)
    w.demote(shard=1, segment=2, **COLD)
    gen = os.path.join(d, "shard-0001", "v0000")
    assert os.path.exists(os.path.join(gen, "cold-0002.rlz"))
    w.extend([b"tail append"])
    w.save()  # the tail shard's generation lists its cold segment
    for opened in (ShardedStringStore.open(d, device=CPU),
                   RefSharded.open(d, backend="numpy")):
        assert sorted(opened.stores[1].tier.cold) == [2]
        assert opened.scan(0, 1200) == titles[:1200]
        assert opened.get(1200) == b"tail append"
    # a store built in memory still writes to a temporary directory
    monkeypatch.undo()
    tier = port.enable_tiering(**COLD)
    tier.demote(0)
    assert os.path.dirname(tier.cold[0].path) != d
