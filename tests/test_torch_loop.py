"""repro_torch.runtime.loop and ``python -m repro_torch.launch.train``: the
reference's loop cases of ``tests/test_system.py`` on the port (resume from
the latest checkpoint ``:133``, preemption ``:165``, the straggler watchdog
``:191``, with ``install_signals=False`` as there), a resumed run's losses
equal to an uninterrupted run's (the restore is bit-exact and each batch a
pure function of its step); and the launcher on the host: a smoke run with
its ``done:`` line, the tokenizer's vocabulary, a resume through two
launches, SIGTERM mid-run (a synchronous save, exit 0), and its refusals
(no card without ``--device cpu``; ``--mesh``)."""

import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs import REGISTRY
from repro_torch.core.tokenizer import VOCAB_SIZE
from repro_torch.launch.train import build_parser, train_lm
from repro_torch.models.model import demo_batch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.loop import LoopConfig, TrainLoop
from repro_torch.train.state import make_abstract_state, make_state
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import leaves, tree_map

CPU = "cpu"
SRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "src")
CHILD_ENV = {**os.environ, "PYTHONPATH": SRC_DIR, "OMP_NUM_THREADS": "1"}
NO_CARD_ENV = {**CHILD_ENV, "CUDA_VISIBLE_DEVICES": ""}
RUN_S = 300.0  # one launch's time limit here
STEP_LINE_S = 120.0  # deadline for the SIGTERM child's first step line


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: torch's intra-op threads would only contend with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    cfg = REGISTRY["h2o-danube-1.8b"].smoke()
    opt = AdamWConfig(lr=1e-3)
    return cfg, opt, make_train_step(cfg, opt)


def _fresh(cfg, opt):
    return make_state(cfg, opt, seed=0, device=CPU)


def _batch_fn(cfg):
    return lambda step: demo_batch(cfg, batch=2, seq=16, kind="train", seed=step,
                                   device=CPU)


def _quiet(*_):
    return None


def test_train_loop_with_resume(tiny, tmp_path):
    cfg, opt, step_fn = tiny
    lc = LoopConfig(total_steps=6, ckpt_every=3, ckpt_dir=str(tmp_path / "loop"),
                    log_every=100)
    loop = TrainLoop(step_fn, _fresh(cfg, opt), _batch_fn(cfg), lc,
                     install_signals=False)
    stats = loop.run(log=_quiet)
    assert stats.steps_run == 6
    assert ckpt.latest_step(lc.ckpt_dir) == 6

    # crash + restart: a new loop resumes from the committed checkpoint
    lc2 = LoopConfig(total_steps=9, ckpt_every=3, ckpt_dir=lc.ckpt_dir,
                     log_every=100)
    loop2 = TrainLoop(step_fn, _fresh(cfg, opt), _batch_fn(cfg), lc2,
                      abstract_state=make_abstract_state(cfg, opt),
                      install_signals=False)
    stats2 = loop2.run(log=_quiet)
    assert stats2.resumed_from == 6
    assert stats2.steps_run == 3  # only the remaining steps
    assert int(loop2.state["step"]) == 9

    # the same 9 steps uninterrupted: equal losses from step 6 on
    lc3 = LoopConfig(total_steps=9, ckpt_every=100, ckpt_dir=str(tmp_path / "one"),
                     log_every=100)
    whole = TrainLoop(step_fn, _fresh(cfg, opt), _batch_fn(cfg), lc3,
                      install_signals=False).run(log=_quiet)
    assert whole.losses[:6] == stats.losses
    assert whole.losses[6:] == stats2.losses


def test_preemption_saves_and_exits(tiny, tmp_path):
    cfg, opt, step_fn = tiny
    lc = LoopConfig(total_steps=50, ckpt_every=100,
                    ckpt_dir=str(tmp_path / "pre"), log_every=1000)
    loop = TrainLoop(step_fn, _fresh(cfg, opt), _batch_fn(cfg), lc,
                     install_signals=False)
    orig = loop.train_step

    def step_then_preempt(st, b):
        out = orig(st, b)
        if int(out[0]["step"]) >= 2:
            loop._on_preempt(None, None)  # simulated SIGTERM
        return out

    loop.train_step = step_then_preempt
    lines = []
    stats = loop.run(log=lines.append)
    assert stats.preempted
    assert stats.steps_run < 50
    assert ckpt.latest_step(lc.ckpt_dir) == stats.steps_run == 2
    assert lines == ["[preempt] saved step 2 and exiting"]
    restored, _ = ckpt.restore(lc.ckpt_dir, make_abstract_state(cfg, opt),
                               device=CPU)
    for a, b in zip(leaves(restored), leaves(loop.state)):
        assert torch.equal(a, b)


def test_straggler_watchdog_counts(tiny, tmp_path):
    cfg, opt, step_fn = tiny
    calls = {"n": 0}

    def slow_once(st, b):
        calls["n"] += 1
        if calls["n"] == 8:
            # injected straggler: past 3x the median of the steps before it,
            # however slow a loaded host makes them
            time.sleep(1.0 + 4 * float(np.median(loop.stats.step_times)))
        return step_fn(st, b)

    lc = LoopConfig(total_steps=10, ckpt_every=1000,
                    ckpt_dir=str(tmp_path / "wd"), log_every=1000,
                    straggler_factor=3.0)
    base = _batch_fn(cfg)
    loop = TrainLoop(slow_once, _fresh(cfg, opt), lambda s: base(s % 3), lc,
                     install_signals=False)
    lines = []
    stats = loop.run(log=lines.append)
    assert stats.straggler_steps >= 1
    assert any(ln.startswith("[watchdog] step 7:") for ln in lines)


def test_a_restored_state_lands_on_the_loops_device(tiny, tmp_path):
    cfg, opt, step_fn = tiny
    d = str(tmp_path / "dev")
    ckpt.save(_fresh(cfg, opt), 4, d)
    loop = TrainLoop(step_fn, _fresh(cfg, opt), _batch_fn(cfg),
                     LoopConfig(total_steps=4, ckpt_dir=d),
                     abstract_state=make_abstract_state(cfg, opt),
                     install_signals=False)
    assert loop.device == torch.device("cpu")
    assert loop.maybe_resume() == 4
    assert {t.device.type for t in leaves(loop.state)} == {"cpu"}


# ---------------------------------------------------------------- launcher
def _train(args, env=CHILD_ENV):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          capture_output=True, text=True, env=env, timeout=RUN_S)


def test_launcher_trains_on_the_host(tmp_path):
    stats_path = tmp_path / "stats.json"
    proc = _train(["--smoke", "--device", "cpu", "--steps", "4", "--batch", "2",
                   "--seq", "32", "--ckpt-dir", str(tmp_path / "ck"),
                   "--stats-json", str(stats_path)])
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("corpus: ") and " docs, ratio " in lines[0]
    assert lines[1].startswith(f"arch=mamba2-780m params=4.3M (smoke=True, "
                               f"vocab {VOCAB_SIZE}, cpu)")
    assert lines[-1].startswith("done: 4 steps, resumed_from=None, loss ")
    stats = json.loads(stats_path.read_text())
    assert stats["vocab_size"] == VOCAB_SIZE and stats["steps_run"] == 4
    assert len(stats["losses"]) == 4 and np.all(np.isfinite(stats["losses"]))
    assert ckpt.latest_step(str(tmp_path / "ck")) is None  # ckpt-every 25 > 4


def test_launcher_refuses_without_a_card_and_refuses_a_mesh(tmp_path):
    proc = _train(["--smoke", "--steps", "1"], env=NO_CARD_ENV)
    assert proc.returncode == 1
    assert "CUDA is not available" in proc.stderr
    assert "corpus:" not in proc.stdout  # nothing was built
    # a mesh of two devices in a launch of one process
    proc = _train(["--smoke", "--device", "cpu", "--mesh", "2,1"], env=NO_CARD_ENV)
    assert proc.returncode == 2
    assert "--mesh 2,1 needs 2 processes" in proc.stderr
    assert proc.stdout == ""


def test_launcher_resumes_where_the_last_run_stopped(tmp_path):
    """--steps 6 --ckpt-every 3, then --steps 9 on the same directory: 3
    steps from step 6, whose losses equal an uninterrupted 9-step run's."""
    common = ["--smoke", "--batch", "2", "--seq", "16", "--data-mib", "1",
              "--ckpt-every", "3"]

    def run(steps, d):
        args = build_parser().parse_args(common + ["--steps", str(steps),
                                                   "--ckpt-dir", str(d)])
        return train_lm(args, CPU, install_signals=False)

    first = run(6, tmp_path / "a")["loop"].stats
    second = run(9, tmp_path / "a")
    whole = run(9, tmp_path / "b")["loop"].stats
    assert first.steps_run == 6 and first.resumed_from is None
    stats = second["loop"].stats
    assert stats.resumed_from == 6 and stats.steps_run == 3
    assert second["cfg"].vocab_size == VOCAB_SIZE
    assert whole.losses == first.losses + stats.losses
    assert ckpt.latest_step(str(tmp_path / "a")) == 9


def test_launcher_saves_and_exits_on_sigterm(tmp_path):
    d = tmp_path / "term"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke", "--device",
         "cpu", "--steps", "100000", "--ckpt-every", "100000", "--batch", "2",
         "--seq", "16", "--data-mib", "1", "--ckpt-dir", str(d)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=NO_CARD_ENV)
    lines: queue.Queue = queue.Queue()

    def read():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    out = []
    try:
        deadline = time.monotonic() + STEP_LINE_S
        while not any(ln.startswith("step 10:") for ln in out):
            line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
            assert line is not None, out
            out.append(line)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
        err = proc.communicate(timeout=30)[1]
    reader.join(timeout=10)
    assert not reader.is_alive()
    while (line := lines.get_nowait()) is not None:
        out.append(line)
    assert rc == 0, err
    saved = [ln for ln in out if ln.startswith("[preempt] saved step ")]
    assert len(saved) == 1, out
    step = int(saved[0].split()[3])
    assert step >= 10
    assert ckpt.latest_step(str(d)) == step
    assert out[-1].startswith(f"done: {step} steps, resumed_from=None")
    assert not (d / f"step_{step:08d}.tmp").exists()
