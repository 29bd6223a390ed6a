"""repro_torch.loadgen — SLO-gated traffic harness over the port's serving
stack.

MLPerf-style load generation for the compressed string store, the
reference's (``repro.loadgen``) over the port: a declarative
:class:`WorkloadSpec` (op mix, key popularity, loop discipline, seeded —
same spec + seed ⇒ identical schedule, the reference's schedule op for op),
closed- and open-loop drivers over :class:`repro_torch.client.StoreClient`'s
async surface, and an SLO gate judged on *server-side* latency histograms
(snapshot → diff → merge across shards), with ``trace_dump`` excerpts from
the worst shard attached to every violation.

``python -m repro_torch.loadgen --spec spec.json --url tcp://... --duration
10`` drives a live cluster; ``--spawn <dir>`` launches (and tears down) a
local multi-process one on ``--device`` (default the card), ``--demo``
builds a synthetic corpus first.
"""

from repro_torch.loadgen.cluster import LocalCluster, build_demo_corpus
from repro_torch.loadgen.driver import RunResult, estimate_n_ops, run_workload
from repro_torch.loadgen.slo import (SERVER_HIST, build_report,
                                     collect_rpc_states, collect_scrape_states,
                                     fraction_under, snapshot_server_states,
                                     write_report)
from repro_torch.loadgen.spec import (SLO, Op, WorkloadSpec, build_schedule,
                                      payload_strings)

__all__ = [
    "SERVER_HIST",
    "SLO",
    "LocalCluster",
    "Op",
    "RunResult",
    "WorkloadSpec",
    "build_demo_corpus",
    "build_report",
    "build_schedule",
    "collect_rpc_states",
    "collect_scrape_states",
    "estimate_n_ops",
    "fraction_under",
    "payload_strings",
    "run_workload",
    "snapshot_server_states",
    "write_report",
]
