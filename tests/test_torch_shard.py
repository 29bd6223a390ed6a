"""Segment-sharded stores on the port, held against the JAX package's.

Port stores run on ``device="cpu"`` (the kernels' plain versions) and the
reference's on its numpy backend, over the same seeded titles and the same
artifact. Covered: ``plan_shards``; ``save_sharded`` and
``ShardedStringStore.open`` (multiget, get, scan, locate, scan_prefix,
stats) answer for answer against the reference's sharded store; sharded
directories written by either package open in the other, with the same
``shards.json`` and per-shard ``store.json``; the write path (appends to the
tail shard, concurrent extends, save and reopen, compact of one shard,
out-of-band growth refused); the tier fan-out; the replica manifest; the
span chain of a sharded multiget; and what is the port's own: every shard
on one ``OnPairDevice`` (one upload of the tables), concurrent extends on
two shards growing that device's encode caps, and the default device
refusing to fall back to the CPU."""

import json
import os
import sys
import threading
import types

import numpy as np
import pytest
import torch

from repro.core import registry
from repro.core.codec import Encoder as RefEncoder
from repro.data.synth import load_dataset as ref_load_dataset
from repro.distributed import ShardedStringStore as RefSharded
from repro.distributed import open_shard as ref_open_shard
from repro.distributed import plan_shards as ref_plan_shards
from repro.distributed import save_sharded as ref_save_sharded
from repro.distributed.shard_store import manifest_replicas as ref_manifest_replicas
from repro.distributed.shard_store import record_replicas as ref_record_replicas
from repro.store import CompressedStringStore as RefStore
from repro.store import MutableStringStore as RefMutable
from repro_torch.core import DictArtifact, Encoder
from repro_torch.data.synth import load_dataset
from repro_torch.device import same_device
from repro_torch.distributed import (READ_PREFERENCES, ShardedStringStore,
                                     ShardRouter, check_read_preference,
                                     manifest_replicas, open_shard, plan_shards,
                                     record_replicas, save_sharded)
from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref
from repro_torch.kernels.ops import OnPairDevice
from repro_torch.obs import TRACER
from repro_torch.store import CompressedStringStore, MutableStringStore

SAMPLE = 1 << 18
SPS = 128  # small segments so shards hold several
COLD = {"promote_above": 1e9}  # keep segments cold under test read loops
CPU = torch.device("cpu")
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
def ref_art(titles):
    return registry.train("onpair16", titles, sample_bytes=SAMPLE)


@pytest.fixture(scope="module")
def port_art(ref_art):
    return DictArtifact.from_bytes(ref_art.to_bytes())


def _pair(port_art, ref_art, strings, **kw):
    """(port store, reference store) over the same artifact and corpus."""
    kw.setdefault("strings_per_segment", SPS)
    port = CompressedStringStore(
        port_art, Encoder(port_art, device=CPU).encode(strings), device=CPU, **kw)
    want = RefStore(ref_art, RefEncoder(ref_art).encode(strings),
                    backend="numpy", **kw)
    return port, want


def _sharded_pair(port_art, ref_art, strings, tmp_path, n_shards, name="s",
                  **kw):
    """Each package's flat store saved as ``n_shards`` shards by its own
    ``save_sharded``; returns (port dir, reference dir)."""
    port, want = _pair(port_art, ref_art, strings, **kw)
    pd, rd = str(tmp_path / f"{name}-port"), str(tmp_path / f"{name}-ref")
    assert save_sharded(port, pd, n_shards) == ref_save_sharded(want, rd, n_shards)
    return pd, rd


def _open_pair(pd, rd, writable=False):
    return (ShardedStringStore.open(pd, device=CPU, writable=writable),
            RefSharded.open(rd, writable=writable, backend="numpy"))


def _junk(n: int, length: int = 48, seed: int = 0) -> list:
    """Incompressible strings: a drifted distribution for any dictionary."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, length, dtype=np.uint8).tobytes()
            for _ in range(n)]


def _run_threads(targets) -> None:
    threads = [threading.Thread(target=fn, args=args) for fn, args in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a writer thread hung"


def _json(path):
    with open(path) as f:
        return json.load(f)


def _assert_parentage(trace):
    """Every span is the root or a child of another span in the trace."""
    span_ids = {s["span_id"] for s in trace["spans"]}
    roots = [s for s in trace["spans"] if s["parent_id"] == 0]
    assert len(roots) == 1, f"expected one root span, got {roots}"
    for s in trace["spans"]:
        if s["parent_id"] != 0:
            assert s["parent_id"] in span_ids, f"orphaned span {s}"
        assert s["trace_id"] == trace["trace_id"]


# --------------------------------------------------------------- plan_shards
def test_plan_shards_covers_everything():
    assert plan_shards(10, 4, 3) == [(0, 4), (4, 8), (8, 10)]
    assert plan_shards(3, 10, 5) == [(0, 3)]       # never more shards than segs
    assert plan_shards(0, 4, 2) == [(0, 0)]
    with pytest.raises(ValueError):
        plan_shards(10, 4, 0)


@pytest.mark.parametrize("n_strings", [0, 1, 127, 128, 1000, 801_156])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 7])
def test_plan_shards_equals_reference(n_strings, n_shards):
    for sps in (128, 4096):
        assert plan_shards(n_strings, sps, n_shards) == \
            ref_plan_shards(n_strings, sps, n_shards)


def test_read_preferences():
    assert READ_PREFERENCES == ("primary", "replica", "any")
    assert [check_read_preference(p) for p in READ_PREFERENCES] == \
        list(READ_PREFERENCES)
    with pytest.raises(ValueError):
        check_read_preference("nearest")
    with pytest.raises(ValueError):
        ShardRouter([(0, 4)], read_preference="nearest")


# ------------------------------------------------------------ the read path
def test_sharded_store_roundtrip(titles, port_art, ref_art, tmp_path):
    pd, rd = _sharded_pair(port_art, ref_art, titles, tmp_path, 4,
                           strings_per_segment=256)
    sharded, want = _open_pair(pd, rd)
    assert sharded.bounds == want.bounds
    assert sharded.bounds[0][0] == 0 and sharded.bounds[-1][1] == len(titles)
    ids = np.random.default_rng(5).integers(0, len(titles), 600).tolist()
    assert sharded.multiget(ids) == want.multiget(ids) == [titles[i] for i in ids]
    assert sharded.get(0) == want.get(0) == titles[0]
    with pytest.raises(IndexError):
        sharded.get(len(titles))
    with pytest.raises(IndexError):
        sharded.multiget([0, len(titles)])
    lo, hi = sharded.bounds[1][0] - 50, sharded.bounds[2][0] + 50  # straddles
    assert sharded.scan(lo, hi) == want.scan(lo, hi) == titles[lo:hi]
    assert sharded.scan(0, len(titles)) == titles
    with pytest.raises(IndexError):
        sharded.scan(0, len(titles) + 1)
    snap, rsnap = sharded.stats_snapshot(), want.stats_snapshot()
    assert {k: snap[k] for k in ("n_shards", "n_strings", "bounds")} == \
        {k: rsnap[k] for k in ("n_shards", "n_strings", "bounds")}
    for got, want_shard in zip(snap["shards"], rsnap["shards"]):
        assert set(want_shard) <= set(got)  # the port adds device_dict_bytes
        assert {k: got[k] for k in ("n_strings", "n_segments", "lookups")} == \
            {k: want_shard[k] for k in ("n_strings", "n_segments", "lookups")}


def test_sharded_matches_flat(titles, port_art, ref_art, tmp_path):
    strings = titles[:1200]
    pd, rd = _sharded_pair(port_art, ref_art, strings, tmp_path, 3)
    flat, ref_flat = _pair(port_art, ref_art, strings)
    sharded, want = _open_pair(pd, rd)
    probe = [strings[0], strings[11], strings[500], strings[1199], b"@@absent@@"]
    assert sharded.locate_batch(probe) == flat.locate_batch(probe) == \
        want.locate_batch(probe) == ref_flat.locate_batch(probe)
    assert sharded.locate(strings[700]) == want.locate(strings[700])
    prefix = b"The "
    assert (sharded.scan_prefix(prefix, limit=None)
            == flat.scan_prefix(prefix, limit=None)
            == want.scan_prefix(prefix, limit=None))
    assert sharded.scan_prefix(prefix, limit=5) == flat.scan_prefix(prefix, limit=5)
    page = sharded.scan_prefix(prefix, limit=7)
    after = (page[-1][1], page[-1][0])
    assert sharded.scan_prefix(prefix, limit=7, after=after) == \
        want.scan_prefix(prefix, limit=7, after=after)


def test_every_shard_shares_one_device_codec(titles, port_art, ref_art,
                                             tmp_path, monkeypatch):
    pd, _ = _sharded_pair(port_art, ref_art, titles, tmp_path, 4)
    builds = []
    real = kref.DeviceDict.build

    def counting(d, device):
        builds.append(device)
        return real(d, device)

    monkeypatch.setattr(kref.DeviceDict, "build", staticmethod(counting))
    sharded = ShardedStringStore.open(pd, device=CPU)
    assert len(builds) == 1
    devs = {id(st._device) for st in sharded.stores}
    assert len(devs) == 1
    shared = sharded.stores[0]._device
    assert isinstance(shared, OnPairDevice)
    assert len({st._device.dd.mat16.data_ptr() for st in sharded.stores}) == 1
    # the query encoders and the writable tail's encoder ride on it too
    assert sharded.locate_batch([titles[5]]) == [5]
    assert sharded.stores[2]._query_encoder()._device is shared
    w = ShardedStringStore.open(pd, device=CPU, writable=True)
    assert len(builds) == 2
    assert len({id(st._device) for st in w.stores}) == 1
    assert all(st._encoder._device is st._device for st in w.stores)
    # the mirrors together hold the flat store's payload
    flat, _ = _pair(port_art, ref_art, titles)
    assert sum(st.resident.n_bytes for st in sharded.stores) == flat.resident.n_bytes


def test_open_shard_alone_and_with_a_bare_artifact(titles, port_art, ref_art,
                                                   tmp_path):
    pd, rd = _sharded_pair(port_art, ref_art, titles[:600], tmp_path, 2)
    alone = open_shard(pd, 1, device=CPU)
    want = ref_open_shard(rd, 1, backend="numpy")
    assert alone.n_strings == want.n_strings
    assert alone.scan(0, alone.n_strings) == want.scan(0, want.n_strings)
    art = DictArtifact.load(os.path.join(pd, "dictionary.rpa"))
    bare = open_shard(pd, 0, source=art, device=CPU)
    assert bare.artifact is art
    assert bare.multiget([0, 3, 7]) == [titles[0], titles[3], titles[7]]


def test_default_device_raises_without_cuda(titles, port_art, ref_art, tmp_path,
                                            monkeypatch):
    pd, _ = _sharded_pair(port_art, ref_art, titles[:300], tmp_path, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardedStringStore.open(pd)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        open_shard(pd, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardedStringStore.open(pd, writable=True)


def test_shared_source_rejects_another_device(titles, port_art, ref_art,
                                              tmp_path, monkeypatch):
    pd, _ = _sharded_pair(port_art, ref_art, titles[:300], tmp_path, 2)
    art = DictArtifact.load(os.path.join(pd, "dictionary.rpa"))
    shared = OnPairDevice(art, CPU)
    corpus = Encoder(shared).encode([b"x", b"yz"])
    with pytest.raises(ValueError, match="shared device codec"):
        CompressedStringStore(shared, corpus, device="cuda")
    store = CompressedStringStore(shared, corpus)  # the codec's device
    assert store._device is shared and store.backend == "cpu"
    assert store.artifact is art
    assert store.multiget([1, 0]) == [b"yz", b"x"]
    # another card's index is another device: only its type and index agree
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    shared.device = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="shared device codec"):
        CompressedStringStore(shared, corpus, device="cuda:1")
    assert same_device(torch.device("cuda"), torch.device("cuda", 0))
    assert not same_device(torch.device("cuda"), torch.device("cuda", 1))


# ------------------------------------------------------ both packages' files
def test_sharded_dirs_open_in_either_package(titles, port_art, ref_art,
                                             tmp_path):
    pd, rd = _sharded_pair(port_art, ref_art, titles, tmp_path, 3)
    assert _json(os.path.join(pd, "shards.json")) == \
        _json(os.path.join(rd, "shards.json"))
    assert sorted(os.listdir(pd)) == sorted(os.listdir(rd))
    for k in range(3):
        for name in ("store.json", "corpus.rpc"):
            a = os.path.join(pd, f"shard-{k:04d}", name)
            b = os.path.join(rd, f"shard-{k:04d}", name)
            if name.endswith(".json"):
                assert _json(a) == _json(b)
            else:
                assert open(a, "rb").read() == open(b, "rb").read()
    with open(os.path.join(pd, "dictionary.rpa"), "rb") as f, \
            open(os.path.join(rd, "dictionary.rpa"), "rb") as g:
        assert f.read() == g.read()
    ids = np.random.default_rng(6).integers(0, len(titles), 500).tolist()
    port_reads_ref = ShardedStringStore.open(rd, device=CPU)
    ref_reads_port = RefSharded.open(pd, backend="numpy")
    assert port_reads_ref.multiget(ids) == ref_reads_port.multiget(ids) == \
        [titles[i] for i in ids]
    assert port_reads_ref.scan(0, len(titles)) == titles
    assert ref_reads_port.scan(0, len(titles)) == titles


def test_sharded_saves_after_appends_open_in_either_package(titles, port_art,
                                                            ref_art, tmp_path):
    pd, rd = _sharded_pair(port_art, ref_art, titles[:256], tmp_path, 2)
    port, want = _open_pair(pd, rd, writable=True)
    new = [b"persisted-one", b"persisted-two"] + titles[300:420]
    assert port.extend(new) == want.extend(new) == list(range(256, 256 + len(new)))
    port.save()
    want.save()
    assert _json(os.path.join(pd, "shards.json")) == \
        _json(os.path.join(rd, "shards.json"))
    cur = _json(os.path.join(pd, "shard-0001", "current.json"))
    assert cur == _json(os.path.join(rd, "shard-0001", "current.json"))
    meta_p = _json(os.path.join(pd, "shard-0001", cur["current"], "store.json"))
    meta_r = _json(os.path.join(rd, "shard-0001", cur["current"], "store.json"))
    assert {k: meta_p[k] for k in meta_p if k != "async_seal"} == \
        {k: meta_r[k] for k in meta_r if k != "async_seal"}
    n = 256 + len(new)
    both = [ShardedStringStore.open(rd, device=CPU),
            RefSharded.open(pd, backend="numpy")]
    for st in both:
        assert st.n_strings == n
        assert st.multiget(list(range(n))) == titles[:256] + new


# ---------------------------------------------------------- the write path
def test_sharded_append_and_compact_route_to_owning_shard(titles, port_art,
                                                          ref_art, tmp_path):
    pd, rd = _sharded_pair(port_art, ref_art, titles[:512], tmp_path, 2)
    sharded, want = _open_pair(pd, rd, writable=True)
    n0 = sharded.n_strings
    gid = sharded.append(b"routed to the last shard")
    assert gid == want.append(b"routed to the last shard") == n0
    assert sharded.get(gid) == b"routed to the last shard"
    assert sharded.bounds[-1][1] == n0 + 1
    # only the owning (last) shard grew
    assert sharded.stores[-1].n_strings == n0 - sharded.bounds[-1][0] + 1
    assert sharded.stores[0].n_strings == sharded.bounds[0][1]
    ids = sharded.extend(_junk(300))
    assert ids == want.extend(_junk(300)) == list(range(n0 + 1, n0 + 301))
    live = [sharded.get(i) for i in range(sharded.n_strings)]
    assert live == want.multiget(list(range(want.n_strings)))
    shared = sharded.stores[0]._device
    reports = sharded.compact(shard=len(sharded.stores) - 1)
    assert len(reports) == 1
    assert [sharded.get(i) for i in range(sharded.n_strings)] == live
    # the compacted shard retrained onto a device codec of its own; the
    # other keeps the shared one
    assert sharded.stores[0]._device is shared
    assert sharded.stores[-1]._device is not shared


def test_sharded_concurrent_extends_stay_monotonic(titles, port_art, ref_art,
                                                   tmp_path):
    pd, _ = _sharded_pair(port_art, ref_art, titles[:256], tmp_path, 2)
    sharded = ShardedStringStore.open(pd, device=CPU, writable=True)
    results: dict[int, list[int]] = {}
    errs: list = []

    def writer(k):
        try:
            results[k] = sharded.extend([b"w%d-%d" % (k, i) for i in range(50)])
        except Exception as e:
            errs.append(e)

    _run_threads([(writer, (k,)) for k in range(4)])
    assert not errs, errs[0]
    assert sharded.n_strings == 256 + 200         # no lost updates
    assert sorted(i for ids in results.values() for i in ids) == \
        list(range(256, 456))
    for k, ids in results.items():                # every acknowledged id reads
        assert ids == sorted(ids)
        assert sharded.multiget(ids) == [b"w%d-%d" % (k, i) for i in range(50)]


def test_shards_sharing_a_device_grow_encode_caps_concurrently(
        titles, port_art, ref_art, tmp_path):
    """Two shards under different store locks extend at once with strings
    past every encode cap, so both grow the one OnPairDevice's caps: ids and
    payloads are the reference's for the same appends."""
    pd, rd = _sharded_pair(port_art, ref_art, titles[:512], tmp_path, 2)
    sharded = ShardedStringStore.open(pd, device=CPU, writable=True)
    shared = sharded.stores[0]._device
    assert shared.encode_len_caps == [32, 128, 512]
    rng = np.random.default_rng(11)
    batches = {k: [titles[int(i)] * reps
                   for i, reps in zip(rng.integers(0, 512, 24),
                                      rng.integers(20, 120, 24))]
               for k in range(2)}
    assert max(len(s) for b in batches.values() for s in b) > 2048
    results: dict[int, list[int]] = {}
    errs: list = []
    barrier = threading.Barrier(2)

    def writer(k):
        try:
            barrier.wait(JOIN_S)
            results[k] = sharded.stores[k].extend(batches[k])
        except Exception as e:
            errs.append(e)

    _run_threads([(writer, (k,)) for k in range(2)])
    assert not errs, errs[0]
    caps = shared.encode_len_caps
    assert caps[:3] == [32, 128, 512] and caps == sorted(set(caps))
    assert all(b == 2 * a for a, b in zip(caps[2:], caps[3:]))
    assert caps[-1] >= max(len(s) for b in batches.values() for s in b)
    for k in range(2):
        want = ref_open_shard(rd, k, writable=True, backend="numpy")
        assert results[k] == want.extend(batches[k])
        st = sharded.stores[k]
        st.seal_barrier()
        want.seal_barrier()
        assert st.snapshot_corpus().payload.tobytes() == \
            want.snapshot_corpus().payload.tobytes()
        assert st.multiget(results[k]) == batches[k]


def test_shared_state_survives_many_threads(port_art):
    """More threads than cores, a switch interval of a microsecond: the
    launch counts stay exact and the shared device's caps stay one doubling
    chain, as a lost update would break."""
    dev = OnPairDevice(port_art, CPU)
    wrapper = types.SimpleNamespace(launches=0)
    wants = np.random.default_rng(12).integers(1, 1 << 17, (32, 50))
    got: dict[int, list[int]] = {}

    def worker(k):
        got[k] = []
        for n in wants[k].tolist():
            _build.count(wrapper)
            got[k].append((n, dev._encode_cap(n), dev.encode_len_caps))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _run_threads([(worker, (k,)) for k in range(wants.shape[0])])
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == wants.size
    caps = dev.encode_len_caps
    assert caps[:3] == [32, 128, 512] and caps[-1] >= int(wants.max())
    assert all(b == 2 * a for a, b in zip(caps[2:], caps[3:]))
    for rows in got.values():
        for n, cap, seen in rows:
            # the smallest cap of the chain that holds n, from a whole list
            assert cap == next(c for c in caps if n <= c)
            assert seen == caps[:len(seen)] and seen[-1] >= n


def test_sharded_readonly_append_raises(titles, port_art, ref_art, tmp_path):
    pd, _ = _sharded_pair(port_art, ref_art, titles[:256], tmp_path, 2)
    sharded = ShardedStringStore.open(pd, device=CPU)
    with pytest.raises(TypeError):
        sharded.append(b"x")
    with pytest.raises(TypeError):
        sharded.compact()


def test_sharded_appends_persist_across_save_open(titles, port_art, ref_art,
                                                  tmp_path):
    pd, _ = _sharded_pair(port_art, ref_art, titles[:256], tmp_path, 2)
    sharded = ShardedStringStore.open(pd, device=CPU, writable=True)
    ids = sharded.extend([b"persisted-one", b"persisted-two"])
    sharded.save()
    # only the dirty (appended-to) shard was rewritten to a versioned
    # layout; the untouched shard keeps the shared flat layout
    assert not os.path.exists(os.path.join(pd, "shard-0000", "current.json"))
    assert os.path.exists(os.path.join(pd, "shard-0001", "current.json"))
    re = ShardedStringStore.open(pd, device=CPU, writable=True)
    assert re.n_strings == 258
    assert [re.get(i) for i in ids] == [b"persisted-one", b"persisted-two"]
    assert re.multiget(list(range(256))) == titles[:256]
    # a read-only reopen serves the saved appends but rejects writes
    ro = ShardedStringStore.open(pd, device=CPU)
    assert [ro.get(i) for i in ids] == [b"persisted-one", b"persisted-two"]
    with pytest.raises(TypeError):
        ro.extend([b"nope"])
    # save() is in-place only: a router not opened from disk has no target
    with pytest.raises(ValueError):
        ShardedStringStore(re.stores, re.bounds).save()
    with pytest.raises(ValueError):
        ShardedStringStore(re.stores[:1], re.bounds)


def test_sharded_open_rejects_out_of_band_nontail_growth(titles, port_art,
                                                         ref_art, tmp_path):
    port, _ = _pair(port_art, ref_art, titles[:256])
    d = str(tmp_path / "oob-shards")
    save_sharded(port, d, 2)
    shard0 = open_shard(d, 0, device=CPU, writable=True)
    shard0.append(b"smuggled in")
    shard0.save(os.path.join(d, "shard-0000"))
    with pytest.raises(ValueError, match="only the last shard may grow"):
        ShardedStringStore.open(d, device=CPU)
    with pytest.raises(ValueError, match="only the last shard may grow"):
        RefSharded.open(d, backend="numpy")
    # the tail shard growing out of band is fine: its bound extends
    d2 = str(tmp_path / "tail-shards")
    save_sharded(port, d2, 2)
    tail = open_shard(d2, 1, device=CPU, writable=True)
    tail.append(b"tail growth ok")
    tail.save(os.path.join(d2, "shard-0001"))
    for re in (ShardedStringStore.open(d2, device=CPU),
               RefSharded.open(d2, backend="numpy")):
        assert re.n_strings == 257
        assert re.get(256) == b"tail growth ok"


def test_save_sharded_covers_appended_strings(titles, port_art, ref_art,
                                              tmp_path):
    # sharding a writable store snapshots sealed-tail segments and the tail,
    # not the construction-time corpus
    corpus = Encoder(port_art, device=CPU).encode(titles[:300])
    store = MutableStringStore(port_art, corpus, device=CPU,
                               strings_per_segment=256)
    want = RefMutable(ref_art, RefEncoder(ref_art).encode(titles[:300]),
                      strings_per_segment=256, backend="numpy")
    store.extend(titles[300:500])                 # seals one segment + tail
    want.extend(titles[300:500])
    d, rd = str(tmp_path / "append-shards"), str(tmp_path / "append-ref")
    assert save_sharded(store, d, 2) == ref_save_sharded(want, rd, 2)
    assert _json(os.path.join(d, "shards.json"))["bounds"][-1][1] == 500
    sharded = ShardedStringStore.open(d, device=CPU)
    assert sharded.n_strings == 500
    assert sharded.multiget(list(range(500))) == titles[:500]
    for k in range(2):
        for name in ("corpus.rpc", "store.json"):
            a = os.path.join(d, f"shard-{k:04d}", name)
            b = os.path.join(rd, f"shard-{k:04d}", name)
            assert open(a, "rb").read() == open(b, "rb").read()


# ------------------------------------------------------------- tier fan-out
def test_sharded_store_tier_fanout(titles, port_art, ref_art, tmp_path):
    pd, rd = _sharded_pair(port_art, ref_art, titles[:600], tmp_path, 2)
    sharded, want = _open_pair(pd, rd)
    rows = sharded.tier_stats()
    assert rows == want.tier_stats() == [{"enabled": False}] * 2
    demoted = sharded.demote(**COLD)
    assert [r["demoted"] for r in demoted] == \
        [r["demoted"] for r in want.demote(**COLD)]
    assert all(r["n_cold"] > 0 for r in demoted)
    ids = list(range(0, 600, 9))
    assert sharded.multiget(ids) == want.multiget(ids) == [titles[i] for i in ids]
    assert sharded.scan(0, 600) == titles[:600]
    stats = sharded.tier_stats()
    assert [r["n_cold"] for r in stats] == [r["n_cold"] for r in want.tier_stats()]
    assert all(r["enabled"] for r in stats)
    assert sum(st.stats.cold_lookups for st in sharded.stores) == len(ids)
    one = sharded.demote(shard=0, segment=0, **COLD)
    assert len(one) == 1 and one[0]["demoted"] == []  # already cold
    with pytest.raises(ValueError):
        sharded.tier(segment=0)                   # segment needs a shard
    promoted = sharded.promote()
    assert all(r["n_cold"] == 0 for r in promoted)
    assert [r["promoted"] for r in promoted] == \
        [r["promoted"] for r in want.promote()]
    one = sharded.demote(shard=1, segment=1, **COLD)
    assert one == [{"enabled": True, "demoted": [1], "n_cold": 1}]
    assert sharded.multiget(ids) == [titles[i] for i in ids]
    assert sharded.promote(shard=1, segment=1)[0]["promoted"] == [1]


# ----------------------------------------------------------- replica manifest
def test_replica_manifest_is_read_by_either_package(titles, port_art, ref_art,
                                                    tmp_path):
    pd, _ = _sharded_pair(port_art, ref_art, titles[:300], tmp_path, 2)
    assert manifest_replicas(pd) == {}
    assert manifest_replicas(str(tmp_path)) == {}  # not a sharded layout
    got = record_replicas(pd, {0: [("127.0.0.1", 7001)], 1: [("h", 7002)]})
    assert got == {0: [("127.0.0.1", 7001)], 1: [("h", 7002)]}
    assert ref_manifest_replicas(pd) == got
    ref_record_replicas(pd, {1: []})            # an empty list clears a shard
    assert manifest_replicas(pd) == {0: [("127.0.0.1", 7001)]}
    assert ShardedStringStore.open(pd, device=CPU).n_strings == 300


# --------------------------------------------------------------------- trace
def test_trace_spans_sharded_multiget(titles, port_art, ref_art, tmp_path):
    pd, _ = _sharded_pair(port_art, ref_art, titles[:600], tmp_path, 3,
                          cache_bytes=0)
    sharded = ShardedStringStore.open(pd, device=CPU)
    TRACER.clear()
    with TRACER.span("client.multiget", root=True) as root:
        out = sharded.multiget([0, 1, 2, 5, 599])
    assert out == [titles[i] for i in (0, 1, 2, 5, 599)]
    trace = next(t for t in TRACER.trace_dump(8) if t["trace_id"] == root.trace_id)
    names = [s["name"] for s in trace["spans"]]
    assert {"client.multiget", "store.decode"} <= set(names)
    assert names.count("store.decode") == 2       # the two shards touched
    for s in trace["spans"]:
        if s["name"] == "store.decode":
            assert s["parent_id"] == root.span_id
            assert s["annotations"]["backend"] == "cpu"
            assert s["annotations"]["batch"] >= 1
    _assert_parentage(trace)


# ------------------------------------- reopen after a save of appends
def test_reopen_after_a_save_of_appends_uploads_the_tables_once(
        titles, port_art, ref_art, tmp_path, monkeypatch):
    """A shard saved after appends holds the directory's dictionary byte for
    byte, so a sharded reopen opens it on the shared device codec: one
    build of the tables per open, read-only or writable. A compacted shard
    keeps a codec of its own."""
    pd, _ = _sharded_pair(port_art, ref_art, titles[:600], tmp_path, 3)
    sharded = ShardedStringStore.open(pd, device=CPU, writable=True)
    new = sharded.extend([b"appended-%d" % i for i in range(40)])
    sharded.save()
    tail = os.path.join(pd, "shard-0002")
    gen = _json(os.path.join(tail, "current.json"))["current"]
    with open(os.path.join(tail, gen, "dictionary.rpa"), "rb") as a, \
            open(os.path.join(pd, "dictionary.rpa"), "rb") as b:
        assert a.read() == b.read()
    builds = []
    real = kref.DeviceDict.build

    def counting(d, device):
        builds.append(device)
        return real(d, device)

    monkeypatch.setattr(kref.DeviceDict, "build", staticmethod(counting))
    for writable in (False, True):
        builds.clear()
        again = ShardedStringStore.open(pd, device=CPU, writable=writable)
        assert len(builds) == 1, writable
        assert len({id(st._device) for st in again.stores}) == 1
        assert again.multiget(new) == [b"appended-%d" % i for i in range(40)]
        assert again.scan(0, 600) == titles[:600]
    builds.clear()
    assert open_shard(pd, 2, device=CPU).multiget([0]) == [titles[512]]
    assert len(builds) == 1
    # the reference reads the same directory
    assert RefSharded.open(pd, backend="numpy").multiget(new[:3]) == \
        [b"appended-%d" % i for i in range(3)]
    # a compacted shard has a dictionary of its own, on a codec of its own
    again.compact(shard=2)
    again.save()
    builds.clear()
    after = ShardedStringStore.open(pd, device=CPU)
    assert len(builds) == 2
    assert after.stores[2]._device is not after.stores[0]._device
    assert after.stores[0]._device is after.stores[1]._device
    assert after.multiget(new[:2]) == [b"appended-0", b"appended-1"]
