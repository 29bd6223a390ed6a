"""Reverse lookup on repro_torch's store against the JAX package's, answer
for answer: ``locate``/``locate_batch`` (queries encoded through the encode
kernel's plain version, compared in compressed form) and ``scan_prefix``
(binary search of each segment's sorted sidecar, every probe one decode),
on the read store, the writable store's tail before and after a seal,
through compact() and through save/open. The port store serves the
reference's dictionary and corpus on ``device="cpu"``, as
``tests/test_torch_store.py`` builds it."""

import os
import sys
import threading

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # optional dev dep: property tests skip, the rest run
    from _hypothesis_fallback import given, settings, st

from repro.core import make_onpair16
from repro.data.synth import load_dataset as ref_load_dataset
from repro.store import CompressedStringStore as RefStore
from repro.store import MutableStringStore as RefMutable
from repro_torch.core.index import SegmentIndex, fingerprint_one, fingerprints
from repro_torch.core.packed import PackedDictionary
from repro_torch.data.synth import load_dataset
from repro_torch.store import CompressedStringStore, MutableStringStore

SAMPLE = 1 << 16
SPS = 128  # small segments so queries cross many segment boundaries
CPU = torch.device("cpu")
JOIN_S = 60.0


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
    strings = load_dataset("book_titles", SAMPLE)[:1200]
    assert strings == ref_load_dataset("book_titles", SAMPLE)[:1200]
    strings[3] = b""
    strings[7] = b"\x00\xff" * 9
    strings[11] = strings[5]  # a duplicate: locate must return id 5
    return strings


@pytest.fixture(scope="module")
def ref_comp(titles):
    comp = make_onpair16(sample_bytes=SAMPLE)
    comp.train(titles)
    return comp, comp.compress(titles)


@pytest.fixture(scope="module")
def ref_store(ref_comp):
    comp, corpus = ref_comp
    return RefStore(comp, corpus, backend="numpy", strings_per_segment=SPS)


@pytest.fixture(scope="module")
def store(ref_comp):
    """The port's store over the reference's dictionary and corpus."""
    comp, corpus = ref_comp
    return CompressedStringStore(PackedDictionary.build(comp.dictionary.entries),
                                 corpus, device=CPU, strings_per_segment=SPS)


@pytest.fixture(scope="module")
def first_index(titles):
    first: dict[bytes, int] = {}
    for i, s in enumerate(titles):
        first.setdefault(s, i)
    return first


def _mutable_pair(store, ref_store, **kw):
    """(port, reference) writable stores over the same artifact and corpus."""
    kw.setdefault("strings_per_segment", SPS)
    return (MutableStringStore(store.artifact, store.corpus, device=CPU, **kw),
            RefMutable(ref_store.artifact, ref_store.corpus, **kw))


# ----------------------------------------------------------- exact semantics
def test_locate_is_inverse_of_get(store, ref_store, titles, first_index):
    for i in (0, 3, 7, 5, 11, 127, 128, 600, len(titles) - 1):
        assert store.locate(titles[i]) == first_index[titles[i]] \
            == ref_store.locate(titles[i])


def test_locate_miss_returns_none(store, ref_store, titles):
    for q in (b"@@definitely-absent@@", titles[0] + b"\x00",
              titles[42][:-1] + b"\xfe"):
        assert store.locate(q) is None
        assert ref_store.locate(q) is None


def test_locate_batch_mixed_hits_and_misses(store, ref_store, titles, first_index):
    queries = [titles[9], b"@@absent@@", titles[400], titles[11]]
    assert store.locate_batch(queries) == [
        first_index[titles[9]], None, first_index[titles[400]], 5]
    assert store.locate_batch(queries) == ref_store.locate_batch(queries)
    assert store.locate_batch([]) == []


def test_locate_batch_every_string(store, ref_store, titles, first_index):
    """Every string of the corpus in one batch (and each with a byte
    appended, all absent), as the reference answers them one by one."""
    got = store.locate_batch(titles)
    assert got == [first_index[s] for s in titles]
    assert got == ref_store.locate_batch(titles)
    absent = [s + b"\x01" for s in titles]
    assert store.locate_batch(absent) == [first_index.get(s) for s in absent]


@settings(max_examples=30, deadline=None)
@given(st.data())
def test_locate_inverse_property(store, titles, first_index, data):
    i = data.draw(st.integers(0, len(titles) - 1))
    assert store.locate(titles[i]) == first_index[titles[i]]


@settings(max_examples=30, deadline=None)
@given(st.binary(max_size=40))
def test_locate_arbitrary_bytes_never_wrong(store, first_index, s):
    got = store.locate(s)
    if s in first_index:
        assert got == first_index[s]
    else:
        assert got is None


def test_locate_many_walks_each_chain_as_locate(store):
    """The batched probe answers each query as a walk of its own probe
    chain does (the first byte-verified hit before an empty slot), also
    where every occupied slot's fingerprint matches the query's, so every
    candidate needs its bytes compared."""
    seg = store.segments.segments[0]
    with store._lock:
        idx = store._segment_index_locked(seg)
    encoded = [seg.payload[int(a):int(b)].tobytes()
               for a, b in zip(seg.offsets[:-1], seg.offsets[1:])]
    queries = encoded[::3] + [b"", b"\x00\x01", encoded[5] + b"\x00\x00"]
    fps = np.asarray([fingerprint_one(q) for q in queries], dtype=np.uint64)
    offs = np.concatenate(([0], np.cumsum([len(q) for q in queries])))
    np.testing.assert_array_equal(
        fingerprints(np.frombuffer(b"".join(queries), np.uint8), offs), fps)

    def walk(index, fp, q):
        mask = len(index.table_loc) - 1
        slot = int(fp) & mask
        while index.table_loc[slot] != -1:
            loc = int(index.table_loc[slot])
            if index.table_fp[slot] == fp and encoded[loc] == q:
                return loc
            slot = (slot + 1) & mask
        return -1

    got = idx.locate_many(fps, queries, seg.payload, seg.offsets)
    assert got.tolist() == [walk(idx, f, q) for f, q in zip(fps, queries)]
    assert got.tolist() == [-1 if r is None else r for r in
                            (idx.locate(q, seg.payload, seg.offsets) for q in queries)]
    assert got[0] == 0 and got[-1] == -1
    # every occupied slot fingerprints alike: the bytes decide
    forged = SegmentIndex(n=idx.n, table_loc=idx.table_loc, perm=idx.perm,
                          table_fp=np.where(idx.table_loc >= 0, fps[2],
                                            idx.table_fp).astype(np.uint64))
    same = np.full(len(queries), fps[2], dtype=np.uint64)
    got = forged.locate_many(same, queries, seg.payload, seg.offsets)
    assert got.tolist() == [walk(forged, fps[2], q) for q in queries]
    assert got[2] == 6 and got[-1] == -1


# --------------------------------------------------------------- prefix scan
def _expected_prefix(titles, prefix):
    return sorted((s, i) for i, s in enumerate(titles) if s.startswith(prefix))


def test_scan_prefix_ordering_across_segments(store, ref_store, titles):
    prefix = b"The "  # common: hits in many 128-string segments
    expected = _expected_prefix(titles, prefix)
    assert len(expected) > 10
    hits = store.scan_prefix(prefix, limit=None)
    assert [(s, g) for g, s in hits] == expected
    assert hits == ref_store.scan_prefix(prefix, limit=None)


def test_scan_prefix_limit_and_pagination(store, ref_store, titles):
    prefix = b"The "
    expected = _expected_prefix(titles, prefix)
    page1 = store.scan_prefix(prefix, limit=7)
    assert [(s, g) for g, s in page1] == expected[:7]
    g_last, s_last = page1[-1]
    page2 = store.scan_prefix(prefix, limit=7, after=(s_last, g_last))
    assert [(s, g) for g, s in page2] == expected[7:14]
    assert page2 == ref_store.scan_prefix(prefix, limit=7, after=(s_last, g_last))
    pages, after = [], None  # until exhausted
    while True:
        page = store.scan_prefix(prefix, limit=25, after=after)
        if not page:
            break
        pages += page
        after = (page[-1][1], page[-1][0])
    assert [(s, g) for g, s in pages] == expected


def test_scan_prefix_no_match(store):
    assert store.scan_prefix(b"\xfe\xfd\xfc", limit=10) == []


def test_scan_prefix_decodes_through_the_cache(ref_comp, titles):
    """With a cache every probed string decodes once; without one, every
    probe is a decode (one launch of the decode kernel on the card)."""
    comp, corpus = ref_comp
    d = PackedDictionary.build(comp.dictionary.entries)
    cold = CompressedStringStore(d, corpus, device=CPU, strings_per_segment=SPS,
                                 cache_bytes=0)
    warm = CompressedStringStore(d, corpus, device=CPU, strings_per_segment=SPS)
    for s in (cold, warm):
        assert s.scan_prefix(b"A", limit=None) == s.scan_prefix(b"A", limit=None)
    assert warm.stats.decoded_strings < cold.stats.decoded_strings / 2


# ------------------------------------------------------ mutable tail + compact
def test_mutable_tail_locate_before_and_after_seal(store, ref_store):
    m, r = _mutable_pair(store, ref_store, async_seal=False)
    n0 = len(m)
    new = [b"tail-string-%d" % k for k in range(20)]
    ids = m.extend(new)
    assert ids == r.extend(new)
    # visible the moment extend returns (still in the unsealed tail)
    for s, i in zip(new, ids):
        assert m.locate(s) == i == r.locate(s)
        assert m.get(i) == s
    assert m._tail_map is not None
    # force the tail through a seal and re-check
    filler = [b"filler-%d" % k for k in range(150)]
    m.extend(filler)
    r.extend(filler)
    assert m.locate(new[0]) == ids[0]
    assert m.locate(filler[-1]) == n0 + 20 + len(filler) - 1 == r.locate(filler[-1])
    hits = m.scan_prefix(b"tail-string-1", limit=None)
    assert [s for _g, s in hits] == sorted(
        s for s in new if s.startswith(b"tail-string-1"))
    assert hits == r.scan_prefix(b"tail-string-1", limit=None)
    # the seal indexed its new segment as it sealed (anyone has located)
    assert m.segments.segments[-1].index in m._seg_indexes


def test_seal_worker_indexes_new_segments(store, ref_store, titles, first_index):
    """Once anyone has located, the background seal builds each new
    segment's index from its strings decoded off the lock."""
    m, _ = _mutable_pair(store, ref_store)
    assert m.locate(titles[5]) == 5
    n_seg = m.segments.n_segments
    new = [b"async-%d" % k for k in range(3 * SPS + 17)]
    ids = m.extend(new)
    m.seal_barrier()
    assert m.segments.n_segments == n_seg + 3
    assert all(s.index in m._seg_indexes for s in m.segments.segments[n_seg:])
    assert m.locate_batch(new[::40]) == ids[::40]
    assert m.locate(titles[700]) == first_index[titles[700]]


def test_locate_through_compact(store, ref_store, titles, first_index):
    m, r = _mutable_pair(store, ref_store)
    appended = [b"compact-me-%d" % k for k in range(40)]
    ids = m.extend(appended)
    r.extend(appended)
    m.locate(appended[0])
    m.compact()  # new dictionary generation: indexes must rebuild
    r.compact()
    assert m._seg_indexes == {} and m._tail_map is None
    for i in (0, 5, 11, 700):
        assert m.locate(titles[i]) == first_index[titles[i]] == r.locate(titles[i])
    for s, i in zip(appended, ids):
        assert m.locate(s) == i
    # post-compact appends are locatable against the new dictionary
    j = m.append(b"born-after-compact")
    assert m.locate(b"born-after-compact") == j
    assert m.locate(b"@@still-absent@@") is None


def test_locate_during_live_compacts(store, ref_store, titles, first_index):
    """Locates on one thread while another compacts: every answer is right,
    whichever generation it was probed in."""
    m, _ = _mutable_pair(store, ref_store, strings_per_segment=256)
    queries = titles[::37] + [b"@@absent@@"]
    want = [first_index.get(q) for q in queries]
    errors, done = [], threading.Event()

    def compactor():
        try:
            for _ in range(3):
                m.compact()
        except Exception as e:  # reported by the main thread
            errors.append(e)
        finally:
            done.set()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t = threading.Thread(target=compactor)
        t.start()
        rounds = 0
        while not done.is_set() or rounds < 3:
            assert m.locate_batch(queries) == want
            rounds += 1
        t.join(JOIN_S)
    finally:
        sys.setswitchinterval(interval)
    assert not t.is_alive() and not errors
    assert m.version_id == 3 and m.locate_batch(queries) == want


# ----------------------------------------------------------- index persistence
def test_index_persists_through_save_open(store, titles, first_index, tmp_path):
    d = str(tmp_path / "flat")
    store.locate(titles[0])  # force index construction so save persists it
    store.save(d)
    assert os.path.exists(os.path.join(d, "index.npz"))
    reopened = CompressedStringStore.open(d, device=CPU)
    assert reopened._seg_indexes, "persisted index should preload on open"
    assert reopened.locate(titles[321]) == first_index[titles[321]]
    assert reopened.locate(b"@@absent@@") is None


def test_missing_index_file_rebuilds_lazily(store, titles, first_index, tmp_path):
    d = str(tmp_path / "flat2")
    store.save(d)
    idx_path = os.path.join(d, "index.npz")
    if os.path.exists(idx_path):
        os.remove(idx_path)
    reopened = CompressedStringStore.open(d, device=CPU)
    assert reopened._seg_indexes == {}
    assert reopened.locate(titles[100]) == first_index[titles[100]]
    assert reopened._seg_indexes


def test_mutable_save_open_roundtrip(store, ref_store, titles, first_index,
                                     tmp_path):
    d = str(tmp_path / "mut")
    m, _ = _mutable_pair(store, ref_store)
    m.extend([b"persist-me-%d" % k for k in range(10)])
    m.locate(b"persist-me-0")  # build indexes so save writes the sidecar
    m.save(d)
    assert os.path.exists(os.path.join(d, "v0000", "index.npz"))
    reopened = MutableStringStore.open(d, device=CPU)
    assert reopened.locate(b"persist-me-7") == len(titles) + 7
    assert reopened.locate(titles[50]) == first_index[titles[50]]
    assert RefMutable.open(d).locate(b"persist-me-7") == len(titles) + 7


def test_locate_stats_counters(store, ref_store, titles):
    for s in (store, ref_store):
        before = s.stats_snapshot()
        s.locate_batch([titles[1], b"@@absent@@"])
        s.scan_prefix(b"The ", limit=3)
        after = s.stats_snapshot()
        assert after["locates"] - before["locates"] == 2
        assert after["locate_hits"] - before["locate_hits"] == 1
        assert after["prefix_scans"] - before["prefix_scans"] == 1
        assert after["scan_strings"] - before["scan_strings"] == 3
