"""Spawn-or-attach: a throwaway multi-process cluster for one load run.

``python -m repro_torch.loadgen --spawn <dir>`` needs real sockets and real
process isolation — an in-thread server shares the interpreter lock with
the driver and understates every latency. :class:`LocalCluster` launches
one ``python -m repro_torch.net`` process per shard (plus optional
read-only replicas), each on ``device`` (default the card; ``"cpu"`` runs
the kernels' plain versions on the host), waits on each
``SHARD_SERVER_READY`` announce line, records replica addresses into the
cluster manifest (so the client's replica autodiscovery wires read
load-balancing on connect), and tears everything down on exit.

What differs from the reference's: the device (resolved here first, so a
spawn without CUDA and without ``device="cpu"`` raises before any child
starts); the primaries start together and their readiness lines are read
in shard order, each with a deadline (a child that hangs on the card —
its CUDA context, the kernels' library — fails the spawn instead of
hanging it); and every child is killed and reaped on any failure.
"""

from __future__ import annotations

import json
import os
import queue
import re
import subprocess
import sys
import tempfile
import threading

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.shard_store import record_replicas

_READY_RE = re.compile(
    r"SHARD_SERVER_READY port=(?P<port>\d+)"
    r".*?(?:metrics_port=(?P<mport>\d+))?\s+dir=")
_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: deadline for a child's readiness line on the card (CUDA context, the
#: kernels' library load and the store's device mirror come first)
READY_S = 120.0


def _child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


class _Child:
    """One started server process: its readiness line arrives on a
    reader thread, so the wait for it can time out."""

    def __init__(self, argv: list[str]):
        self.err = tempfile.TemporaryFile(mode="w+")
        self.proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                     stderr=self.err, text=True,
                                     env=_child_env())
        self._line: queue.Queue = queue.Queue()
        threading.Thread(target=lambda: self._line.put(
            self.proc.stdout.readline()), daemon=True).start()

    def ready_line(self, timeout_s: float) -> str:
        try:
            return self._line.get(timeout=timeout_s)
        except queue.Empty:
            return ""

    def stderr_tail(self, n: int = 2000) -> str:
        self.err.flush()
        self.err.seek(0)
        return self.err.read()[-n:]

    def reap(self, grace_s: float = 5.0) -> None:
        """Wait for the (terminated) process, kill it if it does not exit
        in ``grace_s``, and close its pipes."""
        try:
            self.proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=grace_s)
        self.proc.stdout.close()
        self.err.close()


class LocalCluster:
    """Shard server processes over one sharded directory; context-managed."""

    def __init__(self, dir_path: str, device: str | torch.device = "cuda",
                 ready_s: float = READY_S):
        self.dir = dir_path
        self.device = resolve_device(device)
        self.ready_s = float(ready_s)
        self.children: list[_Child] = []
        self.addresses: list[tuple[str, int]] = []      # primaries, shard order
        self.metrics_addrs: list[tuple[str, int]] = []  # primaries, shard order
        self.replica_addresses: dict[int, list[tuple[str, int]]] = {}

    @property
    def procs(self) -> list[subprocess.Popen]:
        return [c.proc for c in self.children]

    # ------------------------------------------------------------------ spawn
    def _start(self, shard: int, read_only: bool, metrics: bool) -> _Child:
        argv = [sys.executable, "-m", "repro_torch.net",
                os.path.join(self.dir, f"shard-{shard:04d}"),
                "--device", self.device.type]
        if read_only:
            argv.append("--read-only")
        if metrics:
            argv += ["--metrics-port", "0"]
        child = _Child(argv)
        self.children.append(child)
        return child

    def _await(self, child: _Child, shard: int, read_only: bool
               ) -> tuple[tuple[str, int], tuple[str, int] | None]:
        line = child.ready_line(self.ready_s)
        m = _READY_RE.search(line or "")
        if not m:
            raise RuntimeError(
                f"shard server {shard} (read_only={read_only}) never became "
                f"ready within {self.ready_s:g} s: {line!r}\n"
                f"{child.stderr_tail()}")
        addr = ("127.0.0.1", int(m.group("port")))
        maddr = (("127.0.0.1", int(m.group("mport")))
                 if m.group("mport") else None)
        return addr, maddr

    @classmethod
    def spawn(cls, dir_path: str, n_shards: int | None = None,
              replicas: int = 0, metrics: bool = True,
              device: str | torch.device = "cuda",
              ready_s: float = READY_S) -> "LocalCluster":
        """Launch primaries for every ``shard-NNNN`` under ``dir_path``
        (``n_shards`` limits/checks the count), plus ``replicas`` read-only
        servers per shard, recorded in the manifest for autodiscovery. Every
        child serves on ``device``; each readiness line must come within
        ``ready_s`` seconds."""
        found = sorted(d for d in os.listdir(dir_path)
                       if re.fullmatch(r"shard-\d{4}", d))
        if not found:
            raise FileNotFoundError(f"no shard-NNNN dirs under {dir_path}")
        if n_shards is not None and len(found) != n_shards:
            raise ValueError(
                f"{dir_path} holds {len(found)} shards, expected {n_shards}")
        cluster = cls(dir_path, device=device, ready_s=ready_s)
        try:
            started = [cluster._start(k, read_only=False, metrics=metrics)
                       for k in range(len(found))]
            for k, child in enumerate(started):
                addr, maddr = cluster._await(child, k, read_only=False)
                cluster.addresses.append(addr)
                if maddr:
                    cluster.metrics_addrs.append(maddr)
            if replicas:
                started = [(k, cluster._start(k, read_only=True, metrics=False))
                           for k in range(len(found)) for _ in range(replicas)]
                for k, child in started:
                    addr, _ = cluster._await(child, k, read_only=True)
                    cluster.replica_addresses.setdefault(k, []).append(addr)
                record_replicas(dir_path, cluster.replica_addresses)
        except BaseException:
            cluster.close()
            raise
        return cluster

    # ------------------------------------------------------------------ attach
    @property
    def url(self) -> str:
        hosts = ",".join(f"{h}:{p}" for h, p in self.addresses)
        return f"tcp://{hosts}"

    def connect_kw(self) -> dict:
        """Keyword args for ``repro_torch.client.connect`` against this
        cluster (manifest path enables replica autodiscovery +
        save/compact)."""
        return {"dir_path": self.dir}

    # ---------------------------------------------------------------- teardown
    def close(self) -> None:
        children, self.children = self.children, []
        for c in children:
            if c.proc.poll() is None:
                c.proc.terminate()
        for c in children:
            c.reap()

    def __enter__(self) -> "LocalCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def build_demo_corpus(dir_path: str, n_shards: int = 2,
                      target_mib: int = 8, dataset: str = "urls",
                      seed: int = 0,
                      device: str | torch.device = "cuda") -> int:
    """Train + shard a synthetic corpus under ``dir_path`` on ``device``
    (idempotent: an existing manifest short-circuits). Returns
    ``n_strings``."""
    from repro_torch.data.synth import load_dataset
    from repro_torch.distributed.shard_store import MANIFEST, save_sharded
    from repro_torch.store import CompressedStringStore

    manifest = os.path.join(dir_path, MANIFEST)
    if os.path.exists(manifest):
        with open(manifest, encoding="utf-8") as fh:
            bounds = json.load(fh)["bounds"]
        return bounds[-1][1]
    dev = resolve_device(device)
    strings = load_dataset(dataset, target_mib << 20, seed=seed)
    store = CompressedStringStore.build(strings, seed=seed, device=dev)
    os.makedirs(dir_path, exist_ok=True)
    save_sharded(store, dir_path, n_shards)
    return len(strings)
