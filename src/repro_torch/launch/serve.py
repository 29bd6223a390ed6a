"""Serving launcher of the port: the ``--shard-server`` role.

A per-shard RPC server process for the multi-process serving tier
(:mod:`repro_torch.net`), on the card unless ``--device cpu`` is given::

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --shard-server /data/corpus/shard-0002 --port 9102

It prints the ``SHARD_SERVER_READY port=<p> ...`` line of ``python -m
repro_torch.net`` and serves until interrupted. Without CUDA and without
``--device cpu`` it exits non-zero before opening the store.

The reference launcher's other role — an LM served with on-device OnPair
detokenisation (``--arch``, ``--prompts``, ``--doc-ids``, ``--store-dir``,
``--writable``, ``--append``) — needs the LM substrate, which the port does
not have yet; it comes with that substrate's launchers. Until then
``--shard-server`` is required.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description=__doc__.splitlines()[0],
        epilog="The LM-serving role of the reference's launcher (--arch, "
               "--prompts, --doc-ids, --store-dir, --writable, --append) "
               "comes with the port's LM substrate; until then --shard-server "
               "is required.")
    ap.add_argument("--shard-server", required=True, metavar="SHARD_DIR",
                    help="serve this shard directory (<dir>/shard-000k) over "
                         "TCP via repro_torch.net.shard_server and exit when "
                         "interrupted")
    ap.add_argument("--host", default="127.0.0.1",
                    help="--shard-server bind host")
    ap.add_argument("--port", type=int, default=0,
                    help="--shard-server bind port (0 = kernel-assigned)")
    ap.add_argument("--read-only", action="store_true",
                    help="--shard-server: serve as a read-only replica")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="also serve Prometheus /metrics + the /traces "
                         "slow-request dump on this port (0 = "
                         "kernel-assigned)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the store's kernels run (default: the card; "
                         "cpu runs their plain PyTorch versions on the host)")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    from repro_torch.net.shard_server import run

    try:
        resolve_device(args.device)
    except RuntimeError as exc:
        ap.exit(1, f"{ap.prog}: {exc}\n")
    run(args.shard_server, host=args.host, port=args.port,
        read_only=args.read_only, metrics_port=args.metrics_port,
        device=args.device)


if __name__ == "__main__":
    main()
