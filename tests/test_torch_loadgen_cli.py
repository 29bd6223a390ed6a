"""``python -m repro_torch.loadgen --spawn``, held against the JAX
package's CLI.

``--spawn DIR --demo --device cpu`` builds the demo corpus (8 MiB of
synthetic URLs, encoded by the kernel's plain version on the host: most
of this file's time), spawns its cluster, gates the SLO (exit 0 or 1) and
prints a report with the reference CLI's keys (the keys of the reference's
``build_report``, which its CLI prints); without a card and without
``--device cpu`` a spawn, with or without ``--demo``, exits non-zero with
the device's message and builds nothing. The attach (``--url``) and the
``--shard-server`` launcher are in ``tests/test_torch_launch.py``."""

import json
import os
import subprocess
import sys

import pytest
import torch

import repro.loadgen as ref_lg
from repro.core import registry
from repro.loadgen import driver as ref_driver
from repro.obs import Histogram as RefHistogram
from repro_torch.core import DictArtifact, Encoder
from repro_torch.data.synth import load_dataset
from repro_torch.distributed import save_sharded
from repro_torch.store import CompressedStringStore

SAMPLE = 1 << 16
CPU = torch.device("cpu")
SRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "src")
CHILD_ENV = {**os.environ, "PYTHONPATH": SRC_DIR, "OMP_NUM_THREADS": "1"}
NO_CARD_ENV = {**CHILD_ENV, "CUDA_VISIBLE_DEVICES": ""}
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
    d = str(tmp_path_factory.mktemp("torch-cli") / "shards")
    save_sharded(store, d, 2)
    return d


def _cli(args, env=CHILD_ENV):
    return subprocess.run([sys.executable, "-m", "repro_torch.loadgen", *args],
                          capture_output=True, text=True, env=env, timeout=RUN_S)


def _key_tree(d):
    if isinstance(d, dict):
        return {k: _key_tree(v) for k, v in d.items()}
    return None


def _reference_report_keys() -> dict:
    """The key tree of the report the reference's CLI prints (its
    ``build_report``), for a run with every summary filled in."""
    h = RefHistogram("x")
    for v in (10.0, 100.0, 1000.0):
        h.record(v)
    result = ref_driver.RunResult(loop="closed", duration_s=1.0, ops_issued=3,
                                  ops_ok=3, per_kind={"get": 3},
                                  latency_state=h.state())
    report = ref_lg.build_report(ref_lg.WorkloadSpec(), result, [h.state()],
                                 [h.state()])
    return _key_tree(report)


def _check_report(stdout: str) -> dict:
    report = json.loads(stdout)
    want = _reference_report_keys()
    got = _key_tree(report)
    # per-kind counts and per-shard rows hold data, not schema
    for tree in (got, want):
        tree["run"]["per_kind"] = None
    assert got == want
    assert report["run"]["ops_ok"] > 0
    assert report["run"]["ops_failed"] == 0
    assert report["server_latency"]["count"] > 0
    return report


def test_spawn_demo_on_cpu_gates_and_reports(tmp_path):
    d = str(tmp_path / "demo")
    proc = _cli(["--spawn", d, "--demo", "--device", "cpu", "--duration", "2",
                 "--out", str(tmp_path / "report.json")])
    assert proc.returncode in (0, 1), proc.stderr
    assert "demo corpus ready" in proc.stderr
    report = _check_report(proc.stdout)
    assert report["passed"] is (proc.returncode == 0)
    with open(tmp_path / "report.json") as fh:
        assert json.load(fh) == report
    assert len(report["per_shard"]) == 2


def test_spawn_without_a_card_exits_non_zero(sharded_dir, tmp_path):
    for args in (["--spawn", sharded_dir],
                 ["--spawn", str(tmp_path / "empty"), "--demo"]):
        proc = _cli([*args, "--duration", "1"], env=NO_CARD_ENV)
        assert proc.returncode == 2, proc.stderr
        assert "CUDA is not available" in proc.stderr
        assert proc.stdout == ""
    assert not os.path.exists(tmp_path / "empty" / "shards.json")
