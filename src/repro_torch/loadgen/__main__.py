"""``python -m repro_torch.loadgen`` — drive a cluster, gate the SLO, write the report.

Attach to a live cluster::

    python -m repro_torch.loadgen --spec spec.json --url tcp://h:p,h:p --duration 10

or spawn (and tear down) a local multi-process one, building a synthetic
demo corpus if the directory is empty::

    python -m repro_torch.loadgen --spawn /tmp/lg --demo --shards 2 --duration 10

The spawned servers and the demo build run on ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain versions on the host), and so
does a directory URL given to ``--url``; without a card and without
``--device cpu`` they fail. Exit status is the gate: 0 = SLO met, 1 =
violated, 2 = run failed outright (a missing card included).
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.client import connect, parse_url
from repro_torch.loadgen.cluster import LocalCluster, build_demo_corpus
from repro_torch.loadgen.driver import run_workload
from repro_torch.loadgen.slo import (build_report, snapshot_server_states,
                                     write_report)
from repro_torch.loadgen.spec import WorkloadSpec


def _parse_metrics_addrs(raw: str | None):
    if not raw:
        return None
    out = []
    for part in raw.split(","):
        host, _, port = part.strip().rpartition(":")
        out.append((host or "127.0.0.1", int(port)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.loadgen",
        description=__doc__.splitlines()[0])
    ap.add_argument("--spec", help="WorkloadSpec JSON file (default: a "
                    "closed-loop 70/30 get/multiget zipf mix)")
    ap.add_argument("--url", help="store URL to attach to (tcp://h:p,...)")
    ap.add_argument("--spawn", metavar="DIR",
                    help="spawn a local cluster over this sharded directory "
                    "instead of attaching")
    ap.add_argument("--demo", action="store_true",
                    help="with --spawn: build a synthetic corpus under DIR "
                    "first if none exists")
    ap.add_argument("--shards", type=int, default=2,
                    help="shard count for --demo corpus build (default 2)")
    ap.add_argument("--replicas", type=int, default=0,
                    help="with --spawn: read-only replicas per shard")
    ap.add_argument("--duration", type=float, default=10.0,
                    help="run length in seconds (default 10)")
    ap.add_argument("--metrics-addrs",
                    help="comma-separated host:port metrics endpoints for "
                    "scrape-based collection (default: stats RPC extension)")
    ap.add_argument("--out", help="write the SLO report JSON here "
                    "(default: stdout only)")
    ap.add_argument("--dir-path",
                    help="cluster manifest directory (enables replica "
                    "autodiscovery when attaching via --url)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where --spawn's servers, the --demo build and a "
                    "directory --url run (default: the card; cpu runs the "
                    "kernels' plain PyTorch versions on the host)")
    args = ap.parse_args(argv)
    if bool(args.url) == bool(args.spawn):
        ap.error("exactly one of --url / --spawn is required")

    spec = (WorkloadSpec.from_file(args.spec) if args.spec
            else WorkloadSpec())

    cluster = None
    try:
        if args.spawn:
            if args.demo:
                n = build_demo_corpus(args.spawn, n_shards=args.shards,
                                      device=args.device)
                print(f"demo corpus ready: {n} strings x {args.shards} shards",
                      file=sys.stderr)
            cluster = LocalCluster.spawn(args.spawn, replicas=args.replicas,
                                         device=args.device)
            url, connect_kw = cluster.url, cluster.connect_kw()
            metrics_addrs = cluster.metrics_addrs
        else:
            url = args.url
            connect_kw = {"dir_path": args.dir_path} if args.dir_path else {}
            if parse_url(url).scheme != "tcp":  # a store opened here
                connect_kw["device"] = args.device
            metrics_addrs = _parse_metrics_addrs(args.metrics_addrs)

        with connect(url, **connect_kw) as client:
            before = snapshot_server_states(client, metrics_addrs)
            result = run_workload(client, spec, args.duration)
            after = snapshot_server_states(client, metrics_addrs)
            report = build_report(spec, result, before, after,
                                  client=client, metrics_addrs=metrics_addrs)
    except (OSError, ConnectionError, ValueError, RuntimeError) as exc:
        print(f"loadgen failed: {exc}", file=sys.stderr)
        return 2
    finally:
        if cluster is not None:
            cluster.close()

    if args.out:
        write_report(args.out, report)
    json.dump(report, sys.stdout, indent=2)
    print()
    if not report["passed"]:
        names = ", ".join(v["slo"] for v in report["violations"])
        print(f"SLO VIOLATED: {names}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
