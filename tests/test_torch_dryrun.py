"""The port's dry-run (``repro_torch.launch.dryrun``) and roofline report
(``repro_torch.launch.roofline``).

* The collectives the dry-run counts for a smoke config's train step on a
  (2, 2) mesh, traced on ``meta`` tensors under torch's fake process group,
  equal what the same step issues on a real gloo (2, 2) run, kind by kind,
  in calls and bytes, counted by the same hook (qwen3-moe, so the MoE's
  routing gathers are in it; FSDP, and q8 moments).
* At (1, 4), where the step is tensor-parallel over ``model``, the
  dry-run's collectives equal a real gloo run's too, and its rank's flops
  are the one-device step's with the share that is split over ``model``
  divided by 4: for qwen3-moe (whole heads, experts, vocabulary-parallel
  head and embedding) everything but the router, whose matmuls (forward,
  remat's recompute and two in the backward, 2 T D E flops each) every
  rank computes whole.
* The mesh prefill and decode steps the dry-run traces for prefill and
  decode cells give, on a real gloo (2, 2) run, the one-device logits and
  cache within 1e-4 of the largest value (the whole-model bound of
  ``tests/test_torch_model.py``): qwen3-moe (attention caches, MoE routed
  over the whole batch) with FSDP, and mamba2-780m (SSM states).
* A production cell (mamba2-780m ``decode_32k`` on the 16x16 mesh, 256
  fake ranks in this process) gives a whole record with the card's
  constants, which the port's ``roofline.load_records`` and ``fmt_row``
  read back from a directory the test gives; the reference's
  ``results/dryrun/`` is not touched.
"""

import math
import os

import pytest
import torch

from _torch_dist import BATCH, SEQ, run_ranks, serve_worker, smoke_cfg, train_worker
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.config import ShapeConfig

CFG = smoke_cfg("qwen3-moe-30b-a3b", 16384)


def test_dryrun_collectives_are_a_real_runs(tmp_path):
    jobs = [("fsdp", (2, 2), True, False, True, 1, True),
            ("q8", (2, 2), True, True, False, 1, True)]
    out = run_ranks(4, train_worker, (CFG, jobs), tmp_path)
    for name, _, remat, q8, fsdp, _, _ in jobs:
        real = torch.load(os.path.join(out, f"{name}.pt"), weights_only=False)["counted"]
        traced = dryrun.trace_step(CFG, ShapeConfig("smoke", SEQ, BATCH, "train"), 4,
                                   lambda dt: make_host_mesh(2, 2, device_type=dt),
                                   fsdp=fsdp, quantized=q8, remat=remat)
        assert traced["collective_calls"] == real["calls"], name
        assert traced["collectives"] == real["bytes"], name
        assert traced["collective_bytes_total"] == sum(real["bytes"].values()) > 0
        assert {"all-gather", "reduce-scatter" if not q8 else "all-reduce"} <= set(real["bytes"])
        assert traced["flops"] > 0 and traced["op_bytes"] > traced["flops"] / 1e3


def test_dryrun_of_the_tensor_parallel_step(tmp_path):
    jobs = [("tp", (1, 4), True, False, False, 1, True)]
    out = run_ranks(4, train_worker, (CFG, jobs), tmp_path)
    real = torch.load(os.path.join(out, "tp.pt"), weights_only=False)["counted"]
    shape = ShapeConfig("smoke", SEQ, BATCH, "train")
    traced = {m: dryrun.trace_step(CFG, shape, m,
                                   lambda dt, m=m: make_host_mesh(1, m, device_type=dt))
              for m in (1, 4)}
    assert traced[4]["collective_calls"] == real["calls"]
    assert traced[4]["collectives"] == real["bytes"]
    assert real["calls"]["all-reduce"] > traced[1]["collective_calls"]["all-reduce"]
    router = CFG.n_blocks * 4 * 2 * (BATCH * SEQ) * CFG.d_model * CFG.n_experts
    assert traced[4]["flops"] == (traced[1]["flops"] - router) / 4 + router
    assert traced[4]["argument_size_in_bytes"] < traced[1]["argument_size_in_bytes"] / 2


def test_roofline_reads_the_dryrun_records(tmp_path):
    root = str(tmp_path / "dry")
    rec = dryrun.run_cell("mamba2-780m", "decode_32k", False, False, root=root)
    assert "error" not in rec, rec.get("traceback")
    assert rec["device"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert (rec["peak_flops"], rec["hbm_bw"], rec["link_bw"]) == (989e12, 3.35e12, 450e9)
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    for key in ("flops_hlo_raw", "bytes_hlo_raw", "compile_s"):
        assert key not in rec
    assert rec["t_compute_s"] == rec["flops"] / 989e12
    assert rec["t_collective_s"] == rec["collective_bytes_total"] / 450e9
    assert rec["bytes_accessed"] > rec["memory"]["argument_size_in_bytes"] > 0
    recs = roofline.load_records("16x16", root)
    assert [r["_file"] for r in recs] == ["mamba2-780m__decode_32k.json"]
    row = roofline.fmt_row(recs[0])
    assert row["bottleneck"] == rec["bottleneck"] and row["device"] == rec["device"]
    bound = max(rec["t_compute_s"], rec["t_memory_s"], rec["t_collective_s"])
    assert math.isclose(roofline.roofline_fraction(rec),
                        rec["model_flops"] / 256 / 989e12 / bound)
    assert roofline.load_records("2x16x16", root) == []


def test_dryrun_refuses_beside_another_process_group():
    from repro_torch.launch.mesh import fake_process_group

    with fake_process_group(4):
        with pytest.raises(RuntimeError):
            with fake_process_group(4):
                pass


def _close(got, want, what):
    bound = 1e-4 * max(float(want.float().abs().max()), 1e-30)
    err = float((got.float() - want.float()).abs().max())
    assert got.shape == want.shape and err <= bound, (what, err, bound)


def test_mesh_prefill_and_decode_are_the_one_device_steps(tmp_path):
    from repro_torch.models.model import build_params, demo_batch, serve_decode, serve_prefill
    from repro_torch.tree import leaves_with_paths

    jobs = [("moe", CFG, (2, 2), True), ("ssm", smoke_cfg("mamba2-780m", 512), (2, 2), False)]
    out = run_ranks(4, serve_worker, (jobs,), tmp_path)
    for name, cfg, _, _ in jobs:
        params = build_params(cfg, seed=0, device="cpu")
        batch = demo_batch(cfg, BATCH, SEQ, kind="prefill", seed=1, device="cpu")
        logits, cache = serve_prefill(params, batch, cfg, max_seq=SEQ + 4)
        token = demo_batch(cfg, BATCH, 1, kind="decode", seed=2, device="cpu")
        d_logits, d_cache = serve_decode(params, cache, token, cfg)
        rows = BATCH // 2
        for r in range(4):
            got = torch.load(os.path.join(out, f"{name}-prefill-rank{r}.pt"))
            i = got["dp_index"]
            _close(got["logits"], logits[i * rows:(i + 1) * rows], f"{name} prefill rank {r}")
        got = torch.load(os.path.join(out, f"{name}-decode.pt"))
        _close(got["logits"], d_logits, f"{name} decode logits")
        want = dict(leaves_with_paths(d_cache))
        for k, t in leaves_with_paths(got["cache"]):
            _close(t, want[k], f"{name} decode cache {k}")
