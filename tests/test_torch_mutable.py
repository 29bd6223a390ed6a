"""repro_torch's writable store against the JAX package's, byte for byte:
every case drives the port's MutableStringStore (device="cpu": the encode,
decode and stream kernels' plain versions) and the reference's
MutableStringStore (numpy encode backend) through the same appends, seals
and compactions, then compares snapshot_corpus() payload and offsets, scan
and multiget. Compactions retrain under the same OnPairConfig."""

import sys
import threading

import numpy as np
import pytest
import torch

from repro.core import registry
from repro.core.codec import Encoder as RefEncoder
from repro.data.synth import load_dataset as ref_load_dataset
from repro.store import DriftMonitor as RefDriftMonitor
from repro.store import MutableStringStore as RefMutable
from repro_torch.core.codec import Encoder
from repro_torch.core.onpair import OnPairConfig, train_dictionary
from repro_torch.core.packed import PackedDictionary
from repro_torch.data.synth import load_dataset
from repro_torch.kernels import _build, ops, ref
from repro_torch.store import (CompressedStringStore, DriftMonitor,
                               MutableStringStore)

SAMPLE = 1 << 18
SPS = 256  # small segments so appends cross seal boundaries quickly
CPU = torch.device("cpu")
CFG = OnPairConfig.onpair16(sample_bytes=SAMPLE)
JOIN_S = 60.0


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
def artifact(titles):
    return registry.train("onpair16", titles, sample_bytes=SAMPLE)


@pytest.fixture(scope="module")
def port_dict(titles, artifact):
    """The port's own training under the same config gives the same entries."""
    entries = train_dictionary(titles, CFG).entries
    assert entries == artifact.entries
    return PackedDictionary.build(entries)


def _junk(n: int, length: int = 48, seed: int = 0) -> list:
    """Incompressible strings: a drifted distribution for any dictionary."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, length, dtype=np.uint8).tobytes()
            for _ in range(n)]


def _pair(artifact, port_dict, strings, **kw):
    """(port store, reference store) over the same base strings."""
    kw.setdefault("strings_per_segment", SPS)
    kw.setdefault("cache_bytes", 1 << 20)
    ref_corpus = RefEncoder(artifact).encode(strings) if strings else None
    port_corpus = Encoder(port_dict, device=CPU).encode(strings) if strings else None
    return (MutableStringStore(port_dict, port_corpus, device=CPU, config=CFG, **kw),
            RefMutable(artifact, ref_corpus, **kw))


def _same(port, refstore, seed=0):
    """Byte-for-byte: the flat snapshot, a full scan and a multiget."""
    port.seal_barrier()
    refstore.seal_barrier()
    got, want = port.snapshot_corpus(), refstore.snapshot_corpus()
    np.testing.assert_array_equal(got.payload, want.payload)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    assert got.raw_bytes == want.raw_bytes
    n = port.n_strings
    assert n == refstore.n_strings
    live = port.scan(0, n)
    assert live == refstore.scan(0, n)
    if n:
        ids = np.random.default_rng(seed).integers(0, n, 200).tolist()
        ids += [0, n - 1, n // 2]
        assert port.multiget(ids) == refstore.multiget(ids) == [live[i] for i in ids]
    return live


def _counts(store):
    snap = store.stats_snapshot()
    return snap["n_sealed_strings"], snap["n_tail_strings"], snap["n_strings"]


def test_build_then_compact_retrains_with_build_settings():
    """build(sample_bytes=, seed=) keeps its training config, so compact()
    retrains exactly as the reference's store (from its artifact's config)."""
    strings = load_dataset("book_titles", 1 << 19)
    assert strings == ref_load_dataset("book_titles", 1 << 19)
    kw = dict(sample_bytes=256 << 10, seed=7, strings_per_segment=1024)
    port = MutableStringStore.build(strings, device=CPU, **kw)
    refstore = RefMutable.build(strings, backend="numpy", **kw)
    assert port.config == OnPairConfig.onpair16(sample_bytes=256 << 10, seed=7)
    got, want = port.compact(), refstore.compact()
    assert got["ratio_after"] == want["ratio_after"]
    assert got["ratio_before"] == want["ratio_before"]
    a, b = port.snapshot_corpus(), refstore.snapshot_corpus()
    np.testing.assert_array_equal(a.payload, b.payload)
    np.testing.assert_array_equal(a.offsets, b.offsets)


# ------------------------------------------------- append == from-scratch
def test_append_matches_from_scratch_build(titles, artifact, port_dict):
    base, extra = titles[:700], titles[700:1300]
    port, refstore = _pair(artifact, port_dict, base)
    ids = port.extend(extra)
    assert ids == refstore.extend(extra) == list(range(700, 1300))
    assert port.n_strings == 1300
    scratch = CompressedStringStore(
        port_dict, Encoder(port_dict, device=CPU).encode(base + extra),
        device=CPU, strings_per_segment=SPS)
    some = np.random.default_rng(0).integers(0, 1300, 500).tolist()
    assert port.multiget(some) == scratch.multiget(some) == refstore.multiget(some)
    for i in (0, 3, 7, 699, 700, 1299):
        assert port.get(i) == scratch.get(i) == refstore.get(i)
    assert _same(port, refstore) == scratch.scan(0, 1300) == titles[:1300]


def test_appended_ids_are_contiguous_and_empty_ok(titles, artifact, port_dict):
    port, refstore = _pair(artifact, port_dict, titles[:10])
    for store in (port, refstore):
        assert store.extend([]) == []
        assert (store.append(b""), store.append(b"x" * 100)) == (10, 11)
        assert store.get(10) == b"" and store.get(11) == b"x" * 100
    _same(port, refstore)


def test_store_can_start_empty(titles, artifact, port_dict):
    port, refstore = _pair(artifact, port_dict, [])
    assert port.n_strings == 0 and port.scan(0, 0) == [] == refstore.scan(0, 0)
    ids = port.extend(titles[:SPS + 5])
    assert ids == refstore.extend(titles[:SPS + 5])
    assert ids[0] == 0 and port.n_strings == SPS + 5
    assert port.scan(0, SPS + 5) == titles[:SPS + 5]
    port.seal_barrier()                    # let the background seal land
    assert port.segments.n_segments == 1   # one sealed + 5 in the tail
    assert _counts(port) == (SPS, 5, SPS + 5)
    _same(port, refstore)


# --------------------------------------------------------- seal boundaries
def test_seal_boundary_exactly_full_tail(titles, artifact, port_dict):
    port, refstore = _pair(artifact, port_dict, titles[:SPS])
    n_seg0 = port.segments.n_segments
    for store in (port, refstore):
        store.extend(titles[SPS : 2 * SPS])  # exactly fills one tail
        store.seal_barrier()
    assert _counts(port) == _counts(refstore) == (2 * SPS, 0, 2 * SPS)
    assert port.segments.n_segments == n_seg0 + 1
    assert _same(port, refstore) == titles[: 2 * SPS]


def test_seal_boundary_empty_tail_seal_is_noop(titles, artifact, port_dict):
    port, refstore = _pair(artifact, port_dict, titles[:20])
    n_seg = port.segments.n_segments
    for store in (port, refstore):
        store.seal()                        # empty tail: nothing to do
    assert port.segments.n_segments == n_seg
    for store in (port, refstore):
        store.append(b"tailed")
        store.seal()                        # force-seal a short tail
    assert port.segments.n_segments == n_seg + 1
    assert _counts(port) == _counts(refstore) == (21, 0, 21)
    assert port.get(20) == b"tailed"
    _same(port, refstore)


def test_seal_with_partial_base_segment(titles, artifact, port_dict):
    # the base corpus ends mid-segment: sealed tails land behind a short
    # segment, so routing bisects rather than divides
    port, refstore = _pair(artifact, port_dict, titles[: SPS + 37])
    for store in (port, refstore):
        store.extend(titles[SPS + 37 : 3 * SPS])
    assert port.scan(0, 3 * SPS) == titles[: 3 * SPS]
    for gid in (SPS + 36, SPS + 37, 2 * SPS, 3 * SPS - 1):
        assert port.get(gid) == refstore.get(gid) == titles[gid]
    _same(port, refstore)


@pytest.mark.parametrize("async_seal", [True, False])
def test_scan_straddles_sealed_tail_boundary(titles, artifact, port_dict,
                                             async_seal):
    port, refstore = _pair(artifact, port_dict, titles[:300],
                           async_seal=async_seal)
    for store in (port, refstore):
        store.extend(titles[300:350])       # 50 unsealed tail strings
    assert _counts(port) == _counts(refstore) == (300, 50, 350)
    for lo, hi in ((250, 300), (280, 340), (300, 350), (349, 350), (350, 350)):
        assert port.scan(lo, hi) == refstore.scan(lo, hi) == titles[lo:hi]
    with pytest.raises(IndexError):
        port.scan(0, 351)
    ids = [0, 299, 300, 349]
    assert port.multiget(ids) == refstore.multiget(ids) == [titles[i] for i in ids]
    _same(port, refstore)


def test_stats_snapshot_tail_aware(titles, artifact, port_dict):
    port, refstore = _pair(artifact, port_dict, titles[:100])
    for store in (port, refstore):
        store.extend(titles[100:120])
    snap = port.stats_snapshot()
    for key in ("n_sealed_strings", "n_tail_strings", "drift", "compactions",
                "version", "scan_strings"):
        assert key in snap
    assert _counts(port) == _counts(refstore) == (100, 20, 120)
    assert snap["memory_bytes"] >= port._tail_payload_bytes() > 0
    assert port._tail_payload_bytes() == refstore._tail_payload_bytes()
    assert snap["drift"] == refstore.stats_snapshot()["drift"]
    _same(port, refstore)


def test_memory_bytes_stable_across_seal(titles, artifact, port_dict):
    # strings sealed from the tail stay in the resident accounting
    port, refstore = _pair(artifact, port_dict, titles[:100], cache_bytes=0)
    for store in (port, refstore):
        store.append(titles[100])
    before = port.memory_bytes
    assert _counts(port) == _counts(refstore) == (100, 1, 101)
    for store in (port, refstore):
        store.seal()                        # tail -> segment
    assert port.memory_bytes >= before      # nothing vanished
    _same(port, refstore)

    port2, ref2 = _pair(artifact, port_dict, titles[:SPS], cache_bytes=0)
    for store in (port2, ref2):
        store.extend(titles[SPS : 2 * SPS])  # seals a full segment
        store.seal_barrier()
    seg_bytes = sum(s.payload_bytes + s.offsets.nbytes
                    for s in port2.segments.segments)
    assert port2.memory_bytes >= seg_bytes
    _same(port2, ref2)


# --------------------------------------------------------------- compaction
@pytest.mark.parametrize("sample_strings", [None, 300])
def test_compact_after_drift_matches_reference(titles, artifact, port_dict,
                                               sample_strings):
    port, refstore = _pair(artifact, port_dict, titles[:600])
    for store in (port, refstore):
        store.extend(titles[600:700])
        store.extend(_junk(400))            # inject drift
        assert store.drift.should_compact()
    live_before = _same(port, refstore)
    got = port.compact(sample_strings=sample_strings)
    want = refstore.compact(sample_strings=sample_strings)
    for key in ("n_strings", "ratio_before", "ratio_after", "version"):
        assert got[key] == want[key]
    if sample_strings is None:  # trained on every live string
        assert got["ratio_after"] >= got["ratio_before"]
    assert port.compactions == 1 and port.version_id == 1
    assert _same(port, refstore, seed=1) == live_before
    assert port.drift.observations == 0 and port.drift.drift == 0.0


def test_compact_drops_cached_entries_for_rewritten_segments(titles, artifact,
                                                             port_dict):
    port, refstore = _pair(artifact, port_dict, titles[:300])
    port.multiget(list(range(50)))
    port.get(0)
    assert port.cache.hits >= 1 and len(port.cache) > 0
    for store in (port, refstore):
        store.compact()
    assert len(port.cache) == 0             # rewritten segments dropped
    assert port.cache.current_bytes == 0
    assert port.get(0) == titles[0]         # decoded fresh, still right
    _same(port, refstore)


def test_compact_on_empty_store_is_noop(artifact, port_dict):
    port, refstore = _pair(artifact, port_dict, [])
    got, want = port.compact(), refstore.compact()
    assert got["n_strings"] == want["n_strings"] == 0 and port.n_strings == 0
    assert port.version_id == 0
    _same(port, refstore)


def test_auto_compact_triggers_on_drift(titles, artifact, port_dict):
    port, refstore = _pair(artifact, port_dict, titles[:300], auto_compact=True,
                           drift_threshold=0.5)
    for store in (port, refstore):
        store.extend(_junk(600))
    assert port.compactions == refstore.compactions >= 1  # tripped in extend
    assert port.drift.observations == 0                   # window restarted
    live = _same(port, refstore)
    assert port.get(300 + 599) == live[-1] == _junk(600)[-1]


def test_swap_state_never_unpublishes_ids(titles, artifact, port_dict):
    # lock-free n_strings readers rely on the published count never dipping,
    # even while compact() swaps in a corpus that excludes the delta
    port, refstore = _pair(artifact, port_dict, titles[:100])
    new_comp = registry.codec_from_artifact(refstore.artifact)
    new_comp.train(titles[:100])
    new_dict = PackedDictionary.build(train_dictionary(titles[:100], CFG).entries)
    assert new_dict.entries == new_comp.dictionary.entries
    partial = Encoder(new_dict, device=CPU).encode(titles[:80])
    want = new_comp.compress(titles[:80])
    np.testing.assert_array_equal(partial.payload, want.payload)
    with port._lock:
        port._swap_state_locked(new_dict, partial)
        assert port.n_strings == 100         # acknowledged ids stay
    with refstore._lock:
        refstore._swap_state_locked(new_comp, want)
        assert refstore.n_strings == 100
    assert port.version_id == refstore.version_id == 1
    got, want = port.snapshot_corpus(), refstore.snapshot_corpus()
    np.testing.assert_array_equal(got.payload, want.payload)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    assert port.scan(0, 80) == titles[:80]


def _tripwire(store):
    """An encoder that lands a compact() between extend()'s first encode and
    its ingest, as a concurrent compaction would."""
    real_encode = store._encoder.encode
    tripped = {}

    class Tripwire:
        def encode(self, strings):
            if not tripped:
                tripped["hit"] = True
                corpus = real_encode(strings)
                store.compact()              # swaps dictionary + version_id
                return corpus                # now-stale payloads
            return store._encoder.encode(strings)  # the new generation's

    store._encoder = Tripwire()
    return tripped


def test_extend_reparses_when_compact_swaps_mid_encode(titles, artifact,
                                                       port_dict):
    port, refstore = _pair(artifact, port_dict, titles[:100])
    batch = [b"raced string", titles[5]]
    for store in (port, refstore):
        tripped = _tripwire(store)
        ids = store.extend(batch)
        assert tripped and ids == [100, 101]
        assert store.multiget(ids) == batch
    _same(port, refstore)


def test_extend_retry_is_bounded(titles, artifact, port_dict):
    """When every optimistic attempt loses to a (simulated) compact, the
    last attempt encodes under the store lock: extend() ends."""
    port = MutableStringStore(port_dict, device=CPU, config=CFG)
    refstore = RefMutable(artifact)
    batch = titles[:8]
    for store in (port, refstore):
        real = store._encoder
        calls = {"n": 0}

        class Flapping:
            def encode(self, strings, store=store, real=real, calls=calls):
                calls["n"] += 1
                store.version_id += 1       # a compact swaps mid-parse
                return real.encode(strings)

        store._encoder = Flapping()
        assert store.extend(batch) == list(range(8))
        assert calls["n"] == store._MAX_ENCODE_RETRIES + 1
        store._encoder = real
        assert store.multiget(list(range(8))) == batch
    _same(port, refstore)


# ------------------------------------------------------------ drift monitor
def test_drift_monitor_math():
    for m in (DriftMonitor(threshold=0.2, baseline_ratio=2.0, min_bytes=100),
              RefDriftMonitor(threshold=0.2, baseline_ratio=2.0, min_bytes=100)):
        assert m.drift == 0.0 and not m.should_compact()
        m.observe(200, 100)                 # ratio 2.0: no drift
        assert m.drift == pytest.approx(0.0)
        m.observe(200, 300)                 # now 400/400 = 1.0
        assert m.drift == pytest.approx(0.5)
        assert m.should_compact()
        snap = m.snapshot()
        m.reset(3.0)
        assert m.observations == 0 and m.baseline_ratio == 3.0
        assert m.drift == 0.0
    assert snap == {"baseline_ratio": 2.0, "observed_ratio": 1.0, "drift": 0.5,
                    "threshold": 0.2, "observed_raw_bytes": 400,
                    "observed_compressed_bytes": 400, "observations": 2,
                    "should_compact": True}


def test_drift_monitor_min_bytes_floor_and_validation():
    m = DriftMonitor(threshold=0.2, baseline_ratio=4.0, min_bytes=1 << 20)
    m.observe(100, 100)                     # terrible ratio, tiny data
    assert m.drift > 0.2 and not m.should_compact()
    for bad in (1.5, 0.0):
        with pytest.raises(ValueError):
            DriftMonitor(threshold=bad)
        with pytest.raises(ValueError):
            RefDriftMonitor(threshold=bad)
    m2 = DriftMonitor(threshold=0.2)        # no baseline: never drifts
    m2.observe(10, 1000)
    assert m2.drift == 0.0 and not m2.should_compact()


def test_empty_started_store_seeds_baseline_and_detects_drift(titles, artifact,
                                                              port_dict):
    # a store filled only by appends has no train-time ratio: the first
    # observation window seeds the baseline, so drift detection still works
    port, refstore = _pair(artifact, port_dict, [], drift_threshold=0.3)
    for store in (port, refstore):
        store.extend(titles[:800])          # compressible seed window
    assert port.drift.baseline_ratio is not None
    assert port.drift.snapshot() == refstore.drift.snapshot()
    assert not port.drift.should_compact()
    for store in (port, refstore):
        store.extend(_junk(600))            # distribution shift
    assert port.drift.should_compact()
    assert port.drift.snapshot() == refstore.drift.snapshot()
    _same(port, refstore)


@pytest.mark.parametrize("max_entry_len", [None, 32])
def test_mutable_refuses_a_config_the_kernels_cannot_decode(port_dict,
                                                            max_entry_len):
    with pytest.raises(ValueError, match="OnPair16"):
        MutableStringStore(port_dict, device=CPU,
                           config=OnPairConfig(max_entry_len=max_entry_len))


def test_warm_encode_builds_nothing_on_the_cpu(port_dict, monkeypatch):
    """The store warms its tail encoder at open; on the CPU there is no
    kernel library to build or load."""
    def no_build():
        raise AssertionError("the CPU path must not build the CUDA kernels")

    monkeypatch.setattr(_build, "load", no_build)
    ops.OnPairDevice(port_dict, CPU).warm_encode()
    store = MutableStringStore(port_dict, device=CPU, config=CFG)
    assert store.extend([b"warm"]) == [0] and store.get(0) == b"warm"


# -------------------------------------------------------------- concurrency
def _run_threads(targets):
    errs: list = []

    def guard(fn):
        def run():
            try:
                fn()
            except Exception as e:  # reported to the test below
                errs.append(e)
        return run

    threads = [threading.Thread(target=guard(fn)) for fn in targets]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"
    assert not errs, errs[0]


def test_concurrent_extends_and_reads_with_background_seals(titles, artifact,
                                                            port_dict):
    """Four writers and three readers, more threads than the test needs
    cores: no id is lost or read wrong while seals run off-thread."""
    port = MutableStringStore(port_dict, Encoder(port_dict, device=CPU).encode(
        titles[:300]), device=CPU, config=CFG, strings_per_segment=64)
    results: dict[int, list[int]] = {}
    batches = {k: [b"w%d-%d " % (k, i) + titles[i] for i in range(120)]
               for k in range(4)}

    def writer(k):
        def run():
            ids = []
            for c in range(0, 120, 30):
                ids += port.extend(batches[k][c : c + 30])
            results[k] = ids
        return run

    def reader(seed):
        def run():
            rng = np.random.default_rng(seed)
            last = 0
            for _ in range(100):
                n = port.n_strings
                assert n >= last             # monotonic growth
                last = n
                i = int(rng.integers(0, 300))
                assert port.get(i) == titles[i]
                if n > 300:
                    port.scan(max(0, n - 40), n)
        return run

    _run_threads([writer(k) for k in range(4)] + [reader(s) for s in range(3)])
    port.seal_barrier()
    assert port.n_strings == 300 + 4 * 120  # no lost update
    assert sorted(i for ids in results.values() for i in ids) == \
        list(range(300, 780))
    for k, ids in results.items():         # every acknowledged id reads back
        assert port.multiget(ids) == batches[k]
        assert [port.scan(i, i + 1)[0] for i in ids[:5]] == batches[k][:5]
    assert _counts(port)[1] < 64           # the seals drained the tail
    # the same strings appended in the order the ids give them equal the
    # reference's store built the same way
    order = sorted((i, s) for k, ids in results.items()
                   for i, s in zip(ids, batches[k]))
    refstore = RefMutable(artifact, RefEncoder(artifact).encode(titles[:300]),
                          strings_per_segment=64)
    refstore.extend([s for _, s in order])
    refstore.seal_barrier()
    got, want = port.snapshot_corpus(), refstore.snapshot_corpus()
    np.testing.assert_array_equal(got.payload, want.payload)
    np.testing.assert_array_equal(got.offsets, want.offsets)


def test_compact_while_appending(titles, artifact, port_dict):
    """A compact() racing extends: ids stay published and every string
    reads back unchanged after both finish."""
    port = MutableStringStore(port_dict, Encoder(port_dict, device=CPU).encode(
        titles[:400]), device=CPU, config=CFG, strings_per_segment=SPS)
    extra = titles[400:700]
    got: dict[str, list[int]] = {}

    def appender():
        ids = []
        for c in range(0, len(extra), 25):
            ids += port.extend(extra[c : c + 25])
        got["ids"] = ids

    _run_threads([appender, lambda: got.setdefault("report", port.compact())])
    port.seal_barrier()
    assert got["ids"] == list(range(400, 700))
    assert port.compactions == 1
    assert port.scan(0, 700) == titles[:700]
    assert port.multiget(got["ids"][::7]) == extra[::7]
    calls = ref.decode_tokens_ref.calls
    port.scan(0, 10)
    assert ref.decode_tokens_ref.calls > calls  # scan ran the stream decode
