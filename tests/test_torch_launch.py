"""The port's attach and launch command lines: ``python -m
repro_torch.loadgen --url`` and ``python -m repro_torch.launch.serve``,
held against the JAX package's.

Covered: ``--url`` attaches to a running cluster with no spawn of its own
and collects the servers' histograms by scrape, printing a report with the
reference CLI's keys; a directory URL takes ``--device`` and without a card
needs ``--device cpu``; the launcher's ``--shard-server`` child prints
``SHARD_SERVER_READY`` and serves a multiget equal to the reference
server's over the same shard; its LM role on the host (``--smoke --device
cpu``) prints the reference launcher's lines for ``--prompts``, serves
``--doc-ids`` from the in-process store (the reference corpus's strings)
and from stores the reference saved (``--store-dir``, ``--writable
--append``, the appends readable by the reference afterwards); without a
card and without ``--device cpu`` either role exits non-zero with the
device's message. Every child's readiness line is read with a deadline,
and every child is reaped."""

import json
import os
import queue
import re
import subprocess
import sys
import threading

import pytest
import torch

import repro.loadgen as ref_lg
import repro.net as ref_net
from repro.core import registry
from repro.core.tokenizer import OnPairTokenizer as RefTokenizer
from repro.data.synth import load_dataset as ref_load_dataset
from repro.store import CompressedStringStore as RefStore
from repro.store import MutableStringStore as RefMutable
from repro.loadgen import driver as ref_driver
from repro.obs import Histogram as RefHistogram
from repro_torch.client import connect
from repro_torch.core import DictArtifact, Encoder
from repro_torch.data.synth import load_dataset
from repro_torch.distributed import save_sharded
from repro_torch.loadgen import LocalCluster
from repro_torch.net import RemoteShardClient
from repro_torch.store import CompressedStringStore

SAMPLE = 1 << 16
CPU = torch.device("cpu")
SRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "src")
CHILD_ENV = {**os.environ, "PYTHONPATH": SRC_DIR, "OMP_NUM_THREADS": "1"}
NO_CARD_ENV = {**CHILD_ENV, "CUDA_VISIBLE_DEVICES": ""}
READY_S = 60.0  # a spawned child's readiness deadline here
RUN_S = 300.0  # a CLI run's whole time limit here


@pytest.fixture(scope="module")
def titles():
    return load_dataset("book_titles", SAMPLE)


@pytest.fixture(scope="module")
def sharded_dir(titles, tmp_path_factory):
    ref = registry.train("onpair16", titles, sample_bytes=SAMPLE)
    art = DictArtifact.from_bytes(ref.to_bytes())
    store = CompressedStringStore(art, Encoder(art, device=CPU).encode(titles),
                                  device=CPU, strings_per_segment=256)
    d = str(tmp_path_factory.mktemp("torch-launch") / "shards")
    save_sharded(store, d, 2)
    return d


def _cli(args, env=CHILD_ENV):
    return subprocess.run([sys.executable, "-m", "repro_torch.loadgen", *args],
                          capture_output=True, text=True, env=env, timeout=RUN_S)


def _key_tree(d):
    if isinstance(d, dict):
        return {k: _key_tree(v) for k, v in d.items()}
    return None


def _check_report(stdout: str) -> dict:
    """The printed report parses and has the key tree of the reference's
    ``build_report`` (what the reference's CLI prints)."""
    report = json.loads(stdout)
    h = RefHistogram("x")
    h.record(10.0)
    result = ref_driver.RunResult(loop="closed", duration_s=1.0, ops_issued=1,
                                  ops_ok=1, latency_state=h.state())
    want = _key_tree(ref_lg.build_report(ref_lg.WorkloadSpec(), result,
                                         [h.state()], [h.state()]))
    got = _key_tree(report)
    got["run"]["per_kind"] = want["run"]["per_kind"] = None  # data, not schema
    assert got == want
    assert report["run"]["ops_ok"] > 0
    assert report["run"]["ops_failed"] == 0
    assert report["server_latency"]["count"] > 0
    return report


def test_url_attaches_to_a_running_cluster_by_scrape(sharded_dir):
    with LocalCluster.spawn(sharded_dir, device="cpu", ready_s=READY_S) as cluster:
        n_children = len(cluster.procs)
        addrs = ",".join(f"{h}:{p}" for h, p in cluster.metrics_addrs)
        proc = _cli(["--url", cluster.url, "--metrics-addrs", addrs,
                     "--duration", "1"])
        assert proc.returncode in (0, 1), proc.stderr
        report = _check_report(proc.stdout)
        assert len(report["per_shard"]) == 2
        # it attached: no child of its own, the cluster's children served it
        assert "demo corpus" not in proc.stderr
        served = sum(RemoteShardClient(a).stats()["service"]["requests"]
                     for a in cluster.addresses)
        assert served >= report["server_latency"]["count"] > 0
        assert len(cluster.procs) == n_children


def test_url_to_a_directory_takes_the_device(tmp_path, sharded_dir):
    flat = str(tmp_path / "flat")
    with connect(f"shard://{sharded_dir}", device=CPU) as client:
        strings = client.scan(0, 200)
    art = DictArtifact.load(os.path.join(sharded_dir, "dictionary.rpa"))
    CompressedStringStore(art, Encoder(art, device=CPU).encode(strings),
                          device=CPU).save(flat)
    proc = _cli(["--url", f"file://{flat}", "--duration", "1"], env=NO_CARD_ENV)
    assert proc.returncode == 2 and "CUDA is not available" in proc.stderr
    proc = _cli(["--url", f"file://{flat}", "--duration", "1", "--device", "cpu"],
                env=NO_CARD_ENV)
    assert proc.returncode in (0, 1), proc.stderr
    _check_report(proc.stdout)


# ------------------------------------------------------------------ launcher
def _launch(args, env=CHILD_ENV):
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve",
                             *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _ready_line(proc) -> str:
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: lines.put(proc.stdout.readline()),
                     daemon=True).start()
    try:
        return lines.get(timeout=READY_S)
    except queue.Empty:
        return ""


def _stop(proc) -> str:
    if proc.poll() is None:
        proc.kill()
    _, err = proc.communicate(timeout=30)
    return err


def test_launcher_shard_server_serves_the_reference_bytes(sharded_dir, titles):
    shard = os.path.join(sharded_dir, "shard-0001")
    proc = _launch(["--shard-server", shard, "--port", "0", "--device", "cpu",
                    "--metrics-port", "0"])
    ref_server = ref_net.ShardServer.from_dir(shard, backend="numpy").start()
    try:
        line = _ready_line(proc)
        m = re.search(r"SHARD_SERVER_READY port=(\d+) n_strings=(\d+) writable=1 "
                      r"metrics_port=(\d+) dir=", line)
        assert m, (line, _stop(proc))
        port = RemoteShardClient(("127.0.0.1", int(m.group(1))))
        ref = ref_net.RemoteShardClient(ref_server.address)
        n = int(m.group(2))
        ids = [0, 5, n - 1, 17, 5]
        assert port.multiget(ids) == ref.multiget(ids)
        assert port.stats()["store"]["backend"] == "cpu"
        port.close()
        ref.close()
    finally:
        ref_server.close()
        _stop(proc)
    assert proc.returncode is not None


def test_launcher_refuses_without_a_card_or_a_shard(sharded_dir):
    """Without a card and without ``--device cpu`` both roles exit non-zero
    with the device's message (the LM role is the default now that
    ``--shard-server`` is optional); ``--help`` names the LM flags; and
    ``--shard-server`` still starts on the host."""
    shard = os.path.join(sharded_dir, "shard-0000")
    proc = _launch(["--shard-server", shard, "--port", "0"], env=NO_CARD_ENV)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in err
    assert "SHARD_SERVER_READY" not in out
    proc = _launch(["--smoke", "--doc-ids", "3"], env=NO_CARD_ENV)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in err
    assert "prefill:" not in out and "store:" not in out
    proc = _launch(["--help"])
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0
    for flag in ("--arch", "--smoke", "--prompts", "--doc-ids", "--store-dir",
                 "--writable", "--append", "--max-new", "--max-seq",
                 "--metrics-port", "--device", "--shard-server"):
        assert flag in out, flag
    proc = _launch(["--shard-server", shard, "--port", "0", "--device", "cpu"],
                   env=NO_CARD_ENV)
    try:
        line = _ready_line(proc)
        assert line.startswith("SHARD_SERVER_READY port="), (line, _stop(proc))
    finally:
        _stop(proc)


# ------------------------------------------------------------ LM launcher
LM_RUN_S = 300.0  # one LM launch's time limit here


def _lm(args, env=CHILD_ENV):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           "--smoke", "--device", "cpu", *args],
                          capture_output=True, text=True, env=env,
                          timeout=LM_RUN_S)


def _prompt_lines(stdout: str) -> list[str]:
    return [ln for ln in stdout.splitlines() if ln.startswith("  ")]


@pytest.fixture(scope="module")
def ref_corpus():
    """The reference launcher's in-process corpus: 1 MiB of book titles."""
    return ref_load_dataset("book_titles", 1 << 20)


def test_lm_prompts_print_the_reference_lines(ref_corpus):
    proc = _lm(["--prompts", "the quick", "compression", "--max-new", "3"])
    assert proc.returncode == 0, proc.stderr
    tok = RefTokenizer.train(ref_corpus, sample_bytes=1 << 20)
    ids = tok.encode_batch([b"the quick", b"compression"], bos=True)
    L = max(map(len, ids))
    lines = proc.stdout.splitlines()
    assert re.fullmatch(rf"prefill: \(2, {L}\) in \d+\.\d\ds", lines[0]), lines
    assert re.fullmatch(r"decode: 6 tokens in \d+\.\d\ds \(\d+\.\d tok/s, "
                        r"untrained weights\)", lines[1]), lines
    prompts = _prompt_lines(proc.stdout)
    assert len(prompts) == 2
    assert prompts[0].startswith("  'the quick' -> b'the quick")
    assert prompts[1].startswith("  'compression' -> b'compression")


def test_lm_doc_ids_from_the_in_process_store(ref_corpus):
    ids = [3, 17, 4242]
    proc = _lm(["--doc-ids", *map(str, ids), "--max-new", "2"])
    assert proc.returncode == 0, proc.stderr
    n = len(ref_corpus)
    m = re.search(rf"store: {n} docs in {-(-n // 4096)} segments \(cpu backend\), "
                  r"fetched 3 prompts, jit shapes \[.*\]", proc.stdout)
    assert m, proc.stdout
    assert "prefill: (5, " in proc.stdout
    prompts = _prompt_lines(proc.stdout)
    assert len(prompts) == 5
    for line, i in zip(prompts[2:], ids):
        want = ref_corpus[i]
        assert line.startswith(f"  {want.decode('latin-1')!r} -> "), (line, want)
        assert f"-> {want!r}"[:-1] in line


@pytest.fixture(scope="module")
def ref_saved_stores(titles, tmp_path_factory):
    """A read-only and a writable store saved by the reference (numpy
    backend), over the module's titles."""
    art = registry.train("onpair16", titles, sample_bytes=SAMPLE)
    corpus = registry.codec_from_artifact(art).compress(titles)
    root = tmp_path_factory.mktemp("torch-launch-lm")
    flat, mut = str(root / "flat"), str(root / "mut")
    RefStore(art, corpus, backend="numpy", strings_per_segment=256).save(flat)
    RefMutable(art, corpus, backend="numpy", strings_per_segment=256).save(mut)
    return flat, mut


def test_lm_store_dir_serves_the_reference_store(ref_saved_stores, titles):
    flat, mut = ref_saved_stores
    proc = _lm(["--store-dir", flat, "--doc-ids", "0", "7", "--max-new", "2"])
    assert proc.returncode == 0, proc.stderr
    n = len(titles)
    assert f"store: {n} docs in {-(-n // 256)} segments (cpu backend), fetched 2 " \
        "prompts" in proc.stdout
    want = RefStore.open(flat, backend="numpy").multiget([0, 7])
    prompts = _prompt_lines(proc.stdout)[2:]
    assert [ln.split(" -> ")[0] for ln in prompts] == \
        [f"  {w.decode('latin-1')!r}" for w in want]
    # --append needs --writable, with the reference's message
    proc = _lm(["--store-dir", flat, "--append", "x"])
    assert proc.returncode != 0
    assert "--append requires --store-dir with --writable" in proc.stderr
    # a writable store: appended, saved, served, and readable by the reference
    docs = ["a new doc", "another new doc"]
    proc = _lm(["--store-dir", mut, "--writable", "--append", *docs,
                "--doc-ids", "1", "--max-new", "2"])
    assert proc.returncode == 0, proc.stderr
    m = re.search(rf"appended 2 docs \(ids {n}\.\.{n + 1}\), tail \d+ strings, "
                  rf"saved to {re.escape(mut)}, drift \d+\.\d{{3}} "
                  r"\(compact recommended: (True|False)\)", proc.stdout)
    assert m, proc.stdout
    assert "fetched 3 prompts" in proc.stdout
    prompts = [ln.split(" -> ")[0] for ln in _prompt_lines(proc.stdout)[2:]]
    assert prompts == [f"  {titles[1].decode('latin-1')!r}"] + \
        [f"  {d!r}" for d in docs]
    back = RefMutable.open(mut, backend="numpy")
    assert back.multiget([n, n + 1]) == [d.encode() for d in docs]
