"""Load generation on the port: ``repro_torch.loadgen`` held against the
JAX package's ``repro.loadgen``.

Covered: the cases of the reference's ``tests/test_loadgen.py`` on port
stores and servers (``device="cpu"``): deterministic schedules, drivers
over ``file://``, ``shard://`` and ``tcp://``, the server-histogram SLO
gate (both verdicts, with trace excerpts), hedged-read cancellation proved
by server-side op counters, replica autodiscovery from the manifest, the
client-side get batcher and the Prometheus scrape round trip; the
cold-skew cases of ``tests/test_tier.py``; ``build_schedule`` equal to the
reference's, ``Op`` for ``Op``, over a table of specs (every op kind,
every popularity, both loops, ``cold_fraction``, locate misses); spec JSON
written by either package loading in the other; ``build_report`` and
``fraction_under`` equal to the reference's on the same inputs; and
``LocalCluster`` spawning ``python -m repro_torch.net ... --device cpu``
children (a replica each, readiness read with a deadline, every child
reaped), refusing to spawn without a card unless asked for the CPU."""

import os

import numpy as np
import pytest
import torch

import repro.loadgen as ref_lg
from repro.core import registry
from repro.data.synth import load_dataset as ref_load_dataset
from repro.loadgen import driver as ref_driver
from repro.obs import Histogram as RefHistogram
from repro_torch.client import connect, format_tcp_url
from repro_torch.core import DictArtifact, Encoder
from repro_torch.data.synth import load_dataset
from repro_torch.distributed import save_sharded
from repro_torch.distributed.shard_store import manifest_replicas, record_replicas
from repro_torch.loadgen import (SLO, LocalCluster, Op, RunResult, WorkloadSpec,
                                 build_demo_corpus, build_report,
                                 build_schedule, estimate_n_ops,
                                 fraction_under, payload_strings,
                                 run_workload, snapshot_server_states)
from repro_torch.loadgen import cluster as cluster_mod
from repro_torch.net import RemoteShardClient, ShardServer
from repro_torch.obs import (Histogram, MetricsRegistry, hist_state_from_rows,
                             parse_prometheus, render_prometheus)
from repro_torch.store import CompressedStringStore

SAMPLE = 1 << 18
CPU = torch.device("cpu")
READY_S = 60.0  # a spawned child's readiness deadline in these tests


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def titles():
    strings = load_dataset("book_titles", SAMPLE)
    assert strings == ref_load_dataset("book_titles", SAMPLE)
    return strings


@pytest.fixture(scope="module")
def art(titles):
    ref = registry.train("onpair16", titles, sample_bytes=SAMPLE)
    return DictArtifact.from_bytes(ref.to_bytes())


def _store(art, strings, sps=256) -> CompressedStringStore:
    return CompressedStringStore(art, Encoder(art, device=CPU).encode(strings),
                                 device=CPU, strings_per_segment=sps)


@pytest.fixture(scope="module")
def corpus(art, titles, tmp_path_factory):
    """One flat store dir + one 2-shard sharded dir."""
    store = _store(art, titles)
    base = tmp_path_factory.mktemp("torch-loadgen")
    flat = str(base / "flat")
    store.save(flat)
    sharded = str(base / "shards")
    save_sharded(store, sharded, 2)
    return {"flat": flat, "sharded": sharded}


def _servers(d, n, **kw):
    return [ShardServer.from_dir(os.path.join(d, f"shard-{k:04d}"), device=CPU,
                                 **kw).start() for k in range(n)]


# ------------------------------------------------------------------ schedule
#: specs covering every op kind, every popularity, both loops, the
#: cold-skew knob and locate misses
PARITY_SPECS = [
    dict(),
    dict(mix={"get": 0.5, "multiget": 0.3, "scan": 0.2}, loop="open",
         rate=500.0, seed=42),
    dict(mix={k: 1.0 for k in ("get", "multiget", "scan", "locate",
                               "scan_prefix", "append", "extend")}, seed=7,
         multiget_fanout=5, scan_span=33, extend_batch=9),
    dict(mix={"get": 1.0}, distribution="uniform", seed=3),
    dict(mix={"get": 0.6, "multiget": 0.4}, distribution="sequential",
         multiget_fanout=8, loop="open", rate=1000.0),
    dict(mix={"get": 1.0}, zipf_s=1.4, cold_fraction=0.5, cold_band=0.25,
         seed=3),
    dict(mix={"locate": 0.7, "get": 0.3}, locate_miss_fraction=0.4, seed=11),
    dict(mix={"locate": 1.0}, locate_miss_fraction=0.0, seed=2),
    dict(mix={"scan_prefix": 0.5, "scan": 0.5}, distribution="uniform",
         loop="open", rate=50.0, seed=5, cold_fraction=1.0, cold_band=1.0),
    dict(mix={"append": 0.5, "extend": 0.5}, extend_batch=0, seed=1),
]


@pytest.mark.parametrize("kw", PARITY_SPECS, ids=lambda kw: str(sorted(kw)))
@pytest.mark.parametrize("n_strings", [1, 37, 10_000, 3_000_000])
def test_schedule_equals_reference_op_for_op(kw, n_strings):
    got = build_schedule(WorkloadSpec(**kw), n_strings, 700)
    want = ref_lg.build_schedule(ref_lg.WorkloadSpec(**kw), n_strings, 700)
    assert len(got) == len(want) == 700
    assert [tuple(op) for op in got] == [tuple(op) for op in want]
    assert all(isinstance(op, Op) for op in got)


@pytest.mark.parametrize("kw", PARITY_SPECS[:4], ids=lambda kw: str(sorted(kw)))
def test_spec_json_loads_in_the_other_package(kw):
    port = WorkloadSpec(**kw, slo=SLO(p99_ms=5.0, min_goodput=0.9))
    ref = ref_lg.WorkloadSpec(**kw, slo=ref_lg.SLO(p99_ms=5.0, min_goodput=0.9))
    assert port.to_json() == ref.to_json()
    assert WorkloadSpec.from_json(ref.to_json()) == port
    assert ref_lg.WorkloadSpec.from_json(port.to_json()) == ref
    assert build_schedule(WorkloadSpec.from_json(ref.to_json()), 999, 64) == \
        ref_lg.build_schedule(ref, 999, 64)


def test_payloads_and_estimates_equal_reference():
    for kw in PARITY_SPECS:
        spec, ref = WorkloadSpec(**kw), ref_lg.WorkloadSpec(**kw)
        for d in (0.3, 10.0):
            assert estimate_n_ops(spec, d) == ref_lg.estimate_n_ops(ref, d)
        assert payload_strings(spec, np.random.default_rng(4), 9) == \
            ref_lg.payload_strings(ref, np.random.default_rng(4), 9)


class TestSchedule:
    def test_same_seed_same_spec_identical_schedule(self):
        spec = WorkloadSpec(mix={"get": 0.5, "multiget": 0.3, "scan": 0.2},
                            loop="open", rate=500.0, seed=42)
        a = build_schedule(spec, 10_000, 3000)
        b = build_schedule(spec, 10_000, 3000)
        assert a == b
        assert len(a) == 3000

    def test_different_seed_different_schedule(self):
        base = dict(mix={"get": 1.0}, seed=1)
        a = build_schedule(WorkloadSpec(**base), 10_000, 500)
        b = build_schedule(WorkloadSpec(**{**base, "seed": 2}), 10_000, 500)
        assert a != b

    def test_shapes_and_arrivals(self):
        spec = WorkloadSpec(mix={"get": 0.6, "multiget": 0.4},
                            multiget_fanout=8, loop="open", rate=1000.0, seed=0)
        sched = build_schedule(spec, 5000, 2000)
        assert {op.kind for op in sched} == {"get", "multiget"}
        arrivals = [op.at_s for op in sched]
        assert arrivals == sorted(arrivals)  # Poisson schedule is cumulative
        for op in sched:
            if op.kind == "multiget":
                assert len(op.ids) == 8
            assert all(0 <= i < 5000 for i in op.ids)

    def test_closed_loop_arrivals_all_zero(self):
        sched = build_schedule(WorkloadSpec(mix={"get": 1.0}), 100, 64)
        assert all(op.at_s == 0.0 for op in sched)

    def test_spec_json_roundtrip(self):
        spec = WorkloadSpec(mix={"get": 1.0}, loop="open", rate=250.0, seed=9,
                            slo=SLO(p99_ms=5.0, min_goodput=0.9))
        again = WorkloadSpec.from_json(spec.to_json())
        assert again == spec
        assert build_schedule(again, 1000, 100) == build_schedule(spec, 1000, 100)

    @pytest.mark.parametrize("kw", [dict(mix={"teleport": 1.0}),
                                    dict(loop="möbius"), dict(mix={"get": 0.0}),
                                    dict(distribution="pareto"),
                                    dict(cold_fraction=1.5),
                                    dict(cold_band=0.0)])
    def test_spec_validation(self, kw):
        with pytest.raises(ValueError) as got:
            WorkloadSpec(**kw)
        with pytest.raises(ValueError) as want:
            ref_lg.WorkloadSpec(**kw)
        assert str(got.value) == str(want.value)


# ------------------------------------------------------------ cold skew (tier)
def test_cold_fraction_zero_keeps_schedules_identical():
    base = WorkloadSpec(mix={"get": 1.0}, seed=3)
    knob = WorkloadSpec(mix={"get": 1.0}, seed=3, cold_fraction=0.0,
                        cold_band=0.25)
    assert build_schedule(base, 5000, 400) == build_schedule(knob, 5000, 400)


def test_cold_fraction_redirects_reads_into_band():
    spec = WorkloadSpec(mix={"get": 1.0}, seed=3, cold_fraction=0.5,
                        cold_band=0.25)
    n = 10_000
    sched = build_schedule(spec, n, 2000)
    band0 = int(n * 0.75)
    frac = np.mean([op.ids[0] >= band0 for op in sched])
    # zipf alone lands <10% of reads in the top quartile; the knob forces
    # roughly half the draws there
    assert 0.35 < frac < 0.7
    assert build_schedule(spec, n, 2000) == sched
    with pytest.raises(ValueError):
        WorkloadSpec(cold_fraction=1.5)
    with pytest.raises(ValueError):
        WorkloadSpec(cold_band=0.0)


# ------------------------------------------------------------------- drivers
class TestDrivers:
    def test_closed_loop_over_sharded_backend(self, corpus):
        spec = WorkloadSpec(mix={"get": 0.7, "multiget": 0.3}, concurrency=16,
                            seed=3)
        with connect(f"shard://{corpus['sharded']}", device=CPU) as client:
            result = run_workload(client, spec, duration_s=0.5)
        assert result.loop == "closed"
        assert result.ops_ok > 0
        assert result.ops_failed == 0
        assert result.per_kind.get("get", 0) > 0
        assert sum(result.latency_state["counts"]) == result.ops_ok
        assert result.bytes_read > 0

    def test_open_loop_paces_to_rate(self, corpus):
        spec = WorkloadSpec(mix={"get": 1.0}, loop="open", rate=200.0, seed=5)
        with connect(f"shard://{corpus['sharded']}", device=CPU) as client:
            result = run_workload(client, spec, duration_s=1.0)
        assert result.loop == "open"
        assert result.ops_ok > 0
        # paced, not saturating: issue count tracks rate x duration
        assert result.ops_issued <= 2 * 200

    def test_writes_in_mix(self, corpus):
        spec = WorkloadSpec(mix={"get": 0.5, "append": 0.25, "extend": 0.25},
                            concurrency=4, extend_batch=8, seed=11)
        with connect(f"shard://{corpus['sharded']}", device=CPU,
                     writable=True) as client:
            n0 = client.n_strings
            result = run_workload(client, spec, duration_s=0.3)
            assert result.ops_failed == 0
            assert client.n_strings > n0

    def test_every_read_kind_over_file_and_tcp(self, corpus, titles):
        """Every read kind answers without error over file:// and tcp://;
        the bytes each kind read are the source's."""
        spec = WorkloadSpec(mix={"get": 0.3, "multiget": 0.3, "scan": 0.1,
                                 "locate": 0.2, "scan_prefix": 0.1},
                            concurrency=8, seed=13)
        servers = _servers(corpus["sharded"], 2)
        try:
            for url, kw in ((f"file://{corpus['flat']}", {"device": CPU}),
                            (format_tcp_url([s.address for s in servers]), {})):
                with connect(url, **kw) as client:
                    full = build_schedule(spec, client.n_strings, 300)
                    # one op of each kind, cycled: every kind issues
                    sched = [next(op for op in full if op.kind == k)
                             for k in spec.mix]
                    result = run_workload(client, spec, 0.4, schedule=sched)
                    assert result.ops_failed == 0, result.first_errors
                    assert set(result.per_kind) == set(spec.mix)
                    assert result.bytes_read > 0
                    got = client.multiget(list(sched[0].ids))
                    assert got == [titles[i] for i in sched[0].ids]
        finally:
            for s in servers:
                s.close()

    def test_read_only_target_surfaces_write_errors(self, corpus):
        spec = WorkloadSpec(mix={"get": 0.5, "append": 0.5}, concurrency=4,
                            seed=2)
        with connect(f"file://{corpus['flat']}", device=CPU) as client:
            result = run_workload(client, spec, duration_s=0.2)
        assert result.ops_failed > 0 and result.ops_ok > 0
        assert result.first_errors and "append" in result.first_errors[0]


# ------------------------------------------------------------------ SLO gate
class TestSLOGate:
    def _run(self, corpus, slo: SLO):
        spec = WorkloadSpec(mix={"get": 1.0}, concurrency=8, seed=2, slo=slo)
        # file:// runs the local micro-batching service, so the *server*
        # histogram (repro_service_request_latency_us) lives in-process
        with connect(f"file://{corpus['flat']}", device=CPU) as client:
            before = snapshot_server_states(client)
            result = run_workload(client, spec, duration_s=0.3)
            after = snapshot_server_states(client)
            return build_report(spec, result, before, after, client=client)

    def test_gate_passes_under_generous_slo(self, corpus):
        report = self._run(corpus, SLO(p99_ms=10_000.0))
        assert report["passed"] is True
        assert report["violations"] == []
        assert report["server_latency"]["count"] > 0
        assert report["goodput"]["fraction_under_slo"] == 1.0

    def test_gate_fails_under_impossible_slo(self, corpus):
        report = self._run(corpus, SLO(p99_ms=0.0001, min_goodput=1.0))
        assert report["passed"] is False
        names = {v["slo"] for v in report["violations"]}
        assert "p99_ms" in names
        assert "min_goodput" in names
        for v in report["violations"]:
            assert "trace_excerpt" in v  # attached even when empty

    def test_gate_over_tcp_attaches_worst_shard_traces(self, corpus):
        """Over tcp:// the gate reads the servers' histograms by the stats
        RPC and by scrape, equal, and a violation carries the worst shard's
        slowest traces."""
        from repro_torch.obs import start_metrics_server

        servers = _servers(corpus["sharded"], 2)
        metrics = start_metrics_server(port=0)
        try:
            spec = WorkloadSpec(mix={"get": 0.5, "multiget": 0.5}, concurrency=8,
                                seed=4, slo=SLO(p99_ms=0.0001))
            with connect(format_tcp_url([s.address for s in servers])) as client:
                before = snapshot_server_states(client)
                result = run_workload(client, spec, duration_s=0.3)
                after = snapshot_server_states(client)
                report = build_report(spec, result, before, after, client=client)
            assert report["passed"] is False
            assert len(report["per_shard"]) == 2
            assert report["server_latency"]["count"] > 0
            excerpt = report["violations"][0]["trace_excerpt"]
            assert excerpt and all("spans" in t for t in excerpt)
            # the in-thread servers share this process's registry: each
            # stats RPC and one scrape of it read the same series
            from repro_torch.loadgen.slo import (collect_rpc_states,
                                                 collect_scrape_states)
            shard_clients = [RemoteShardClient(s.address) for s in servers]
            rpc = collect_rpc_states(shard_clients)
            scraped = collect_scrape_states([("127.0.0.1", metrics.port)])
            for c in shard_clients:
                c.close()
            assert rpc[0] == rpc[1] == scraped[0]
            assert sum(scraped[0]["counts"]) >= report["server_latency"]["count"]
        finally:
            metrics.close()
            for s in servers:
                s.close()

    def test_fraction_under(self):
        state = {"bounds": [10.0, 100.0], "counts": [5, 5, 0], "sum": 300.0}
        assert fraction_under(state, 10.0) == 0.5
        assert fraction_under(state, 1000.0) == 1.0
        assert fraction_under(state, 5.0) == pytest.approx(0.25)
        assert fraction_under(None, 10.0) == 0.0
        for t in (0.0, 5.0, 10.0, 55.0, 100.0, 1e9):
            assert fraction_under(state, t) == ref_lg.fraction_under(state, t)


def _states(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h = RefHistogram("x")
        for v in rng.lognormal(6, 1.5, 300):
            h.record(float(v))
        out.append(h.state())
    return out


@pytest.mark.parametrize("slo", [SLO(), SLO(p99_ms=0.5, p50_ms=0.1, p999_ms=2.0),
                                 SLO(p99_ms=None, min_goodput=0.5,
                                     max_error_rate=0.01)],
                         ids=["default", "tight", "goodput"])
def test_build_report_equals_reference(slo):
    """The same run and histogram states give the reference's report."""
    before, after = _states(1, 3), _states(2, 3)
    after = [{**a, "counts": [x + y for x, y in zip(a["counts"], b["counts"])],
              "sum": a["sum"] + b["sum"]} for a, b in zip(after, before)]
    h = RefHistogram("c")
    for v in (5.0, 50.0, 500.0):
        h.record(v)
    fields = dict(loop="open", duration_s=2.0, ops_issued=100, ops_ok=98,
                  ops_failed=2, per_kind={"get": 100}, late=3, bytes_read=4096,
                  latency_state=h.state(), first_errors=["get: boom"])
    spec = WorkloadSpec(loop="open", rate=50.0, slo=slo)
    ref_spec = ref_lg.WorkloadSpec.from_dict(spec.to_dict())
    got = build_report(spec, RunResult(**fields), before, after)
    want = ref_lg.build_report(ref_spec, ref_driver.RunResult(**fields), before,
                               after)
    assert got == want


# --------------------------------------------------------------- hedged reads
class TestHedgedReads:
    @pytest.fixture()
    def replicated(self, art, titles, tmp_path):
        """2-shard in-thread cluster + a read-only replica on shard 0."""
        d = str(tmp_path / "shards")
        save_sharded(_store(art, titles[:1500]), d, 2)
        servers = _servers(d, 2)
        replica = ShardServer.from_dir(os.path.join(d, "shard-0000"),
                                       read_only=True, device=CPU).start()
        client = connect(format_tcp_url([s.address for s in servers]))
        client.register_replica(0, replica.address)
        yield client, servers, replica
        client.close()
        for s in [*servers, replica]:
            s.close()

    @staticmethod
    def _reads(server) -> int:
        return sum(server.op_counts.get(op, 0) for op in ("get", "multiget"))

    def test_unfired_hedge_is_cancelled(self, replicated):
        client, _servers_, replica = replicated
        r0 = self._reads(replica)
        for i in range(20):
            assert client.get_hedged(i, hedge_ms=2000.0) == client.get(i)
        assert self._reads(replica) == r0
        assert client.stats()["hedges"] == 0

    def test_fired_hedge_loser_cancelled(self, replicated):
        client, servers, replica = replicated
        n = 40
        p0 = self._reads(servers[0])
        r0 = self._reads(replica)
        expected = client.multiget(list(range(n)))
        base_stats = client.stats()
        for i in range(n):
            assert client.get_hedged(i, hedge_ms=0.0,
                                     hedge_preference="replica") == expected[i]
        stats = client.stats()
        assert stats["hedges"] - base_stats["hedges"] == n
        served_p = self._reads(servers[0]) - p0
        served_r = self._reads(replica) - r0
        assert served_r >= 1
        assert n <= served_p + served_r <= 2 * n + len(expected)

    def test_hedge_budget_retries_failures(self, replicated):
        client, _servers_, _replica = replicated
        with pytest.raises(Exception):
            client.get_hedged(10**9, hedge_ms=0.0, budget=2, timeout=5.0)

    def test_hedged_multiget_and_spec_hedging(self, replicated, titles):
        client, _servers_, _replica = replicated
        assert client.multiget_hedged([0, 3, 1499], hedge_ms=0.0,
                                      hedge_preference="replica") == \
            [titles[0], titles[3], titles[1499]]
        spec = WorkloadSpec(mix={"get": 0.5, "multiget": 0.5}, hedge_ms=1.0,
                            concurrency=4, seed=8)
        result = run_workload(client, spec, duration_s=0.3)
        assert result.ops_ok > 0 and result.ops_failed == 0


# -------------------------------------------------------- replica discovery
class TestReplicaAutodiscovery:
    def test_connect_registers_manifest_replicas(self, art, titles, tmp_path):
        d = str(tmp_path / "shards")
        save_sharded(_store(art, titles[:1500]), d, 2)
        servers = _servers(d, 2)
        replica = ShardServer.from_dir(os.path.join(d, "shard-0001"),
                                       read_only=True, device=CPU).start()
        # one live replica and one dead address: discovery registers the
        # live one and shrugs off the dead one
        record_replicas(d, {1: [replica.address, ("127.0.0.1", 1)]})
        assert manifest_replicas(d)[1][0] == replica.address
        client = None
        try:
            client = connect(format_tcp_url([s.address for s in servers]),
                             dir_path=d)
            r0 = replica.op_counts.get("multiget", 0)
            lo = client.backend.bounds[1][0]
            client.multiget([lo, lo + 1, lo + 2], read_preference="replica")
            assert replica.op_counts.get("multiget", 0) > r0
        finally:
            if client is not None:
                client.close()
            for s in [*servers, replica]:
                s.close()

    def test_auto_replicas_off_by_flag(self, art, titles, tmp_path):
        d = str(tmp_path / "shards")
        save_sharded(_store(art, titles[:800]), d, 1)
        server = ShardServer.from_dir(os.path.join(d, "shard-0000"),
                                      device=CPU).start()
        replica = ShardServer.from_dir(os.path.join(d, "shard-0000"),
                                       read_only=True, device=CPU).start()
        record_replicas(d, {0: [replica.address]})
        try:
            with connect(format_tcp_url([server.address]), dir_path=d,
                         auto_replicas=False) as client:
                r0 = replica.op_counts.get("multiget", 0)
                client.multiget([1, 2], read_preference="any")
                client.multiget([1, 2], read_preference="any")
                assert replica.op_counts.get("multiget", 0) == r0
        finally:
            server.close()
            replica.close()


# ------------------------------------------------------------- get batching
class TestGetBatcher:
    def test_concurrent_gets_coalesce_into_multiget(self, corpus, titles):
        servers = _servers(corpus["sharded"], 2)
        try:
            with connect(format_tcp_url([s.address for s in servers])) as client:
                gets_before = sum(s.op_counts.get("get", 0) for s in servers)
                futs = [client.get_async(i) for i in range(200)]
                assert [f.result(timeout=30) for f in futs] == titles[:200]
                stats = client.stats()
                assert stats["coalesced_gets"] > 0
                assert stats["get_batches"] < 200
                # point reads traveled as multiget RPCs, not per-get calls
                assert sum(s.op_counts.get("get", 0) for s in servers) == gets_before
        finally:
            for s in servers:
                s.close()


# ------------------------------------------------------- scrape round-trip
class TestScrapeRoundTrip:
    def test_prometheus_text_rebuilds_exact_hist_state(self):
        reg = MetricsRegistry()
        hist = reg.register(Histogram("rt_latency_us", {"shard": "0"}))
        for v in (3.0, 42.0, 9001.0, 1e7):
            hist.record(v)
        reg.register(Histogram("rt_latency_us", {"shard": "1"})).record(5.0)
        rows = parse_prometheus(render_prometheus(reg))
        state = hist_state_from_rows(rows, "rt_latency_us", {"shard": "0"})
        assert state == hist.state()
        other = hist_state_from_rows(rows, "rt_latency_us", {"shard": "1"})
        assert sum(other["counts"]) == 1


# ------------------------------------------------------------ LocalCluster
def test_local_cluster_spawns_children_with_a_replica(corpus, titles):
    """Primaries and a read-only replica per shard, each a `python -m
    repro_torch.net ... --device cpu` child; the manifest records the
    replicas and connect() discovers them; close() reaps every child."""
    d = corpus["sharded"]
    cluster = LocalCluster.spawn(d, n_shards=2, replicas=1, device="cpu",
                                 ready_s=READY_S)
    procs = list(cluster.procs)
    try:
        assert len(procs) == 4 and all(p.poll() is None for p in procs)
        assert len(cluster.metrics_addrs) == 2
        assert manifest_replicas(d) == cluster.replica_addresses
        with connect(cluster.url, **cluster.connect_kw()) as client:
            ids = [0, 1, client.backend.bounds[1][0], len(titles) - 1]
            want = [titles[i] for i in ids]
            assert client.multiget(ids) == want
            rep = RemoteShardClient(cluster.replica_addresses[1][0])
            r0 = rep.stats()["ops"].get("multiget", 0)
            assert client.multiget(ids[2:], read_preference="replica") == want[2:]
            assert rep.stats()["ops"].get("multiget", 0) > r0
            assert rep.stats()["store"]["backend"] == "cpu"
            rep.close()
    finally:
        cluster.close()
        record_replicas(d, {})
    assert all(p.poll() is not None for p in procs)
    assert cluster.procs == []


def test_local_cluster_refuses_without_a_card(corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(cluster_mod, "_Child",
                        lambda argv: started.append(argv))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LocalCluster.spawn(corpus["sharded"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_demo_corpus(os.path.join(corpus["sharded"], "..", "nowhere"))
    assert started == []  # refused before any child started


def test_local_cluster_readiness_deadline_reaps_every_child(corpus, monkeypatch):
    """A child whose readiness line does not come in time fails the spawn,
    and every child started is killed and reaped."""
    made = []
    real = cluster_mod._Child

    def recording(argv):
        child = real([*argv[:1], "-c", "import time; time.sleep(60)"])
        made.append(child)
        return child

    monkeypatch.setattr(cluster_mod, "_Child", recording)
    with pytest.raises(RuntimeError, match="never became ready within 0.5 s"):
        LocalCluster.spawn(corpus["sharded"], device="cpu", ready_s=0.5)
    assert len(made) == 2
    assert all(c.proc.poll() is not None for c in made)


def test_build_demo_corpus_is_idempotent(tmp_path):
    d = str(tmp_path / "demo")
    n = build_demo_corpus(d, n_shards=2, target_mib=1, dataset="book_titles",
                          device="cpu")
    strings = load_dataset("book_titles", 1 << 20, seed=0)
    assert n == len(strings)
    assert {"shard-0000", "shard-0001", "shards.json"} <= set(os.listdir(d))
    assert build_demo_corpus(d, n_shards=5, device="cpu") == n
    # the reference's sharded store opens it and reads the source back
    from repro.distributed import ShardedStringStore as RefSharded
    assert RefSharded.open(d, backend="numpy").scan(0, n) == strings
